"""PipeGCN core: partition-parallel full-graph GCN training with pipelined
(one-iteration-deferred) boundary feature / feature-gradient communication,
per the paper's Alg. 1 and Eq. 3–4, plus the §3.4 EMA smoothing.

Port of the JAX package's ``repro.core.pipegcn``. Two backends share the
layer math; only the sync points differ (feature exchange, gradient
exchange, weight-gradient and loss reductions):

  SimBackend   every partition on one device as a leading tensor axis; the
               exchange is a transpose of the (sender, receiver) axes.
  SpmdBackend  one process per rank over ``torch.distributed`` (NCCL on the
               card, gloo on the CPU), each holding n_local co-resident
               partitions as its leading axis; the exchange is an
               ``all_to_all_single`` (hierarchical when n_local > 1).

The backward pass is written by hand as in Alg. 1 (a stale gradient
produced at step t is applied at t+1, which autograd cannot express), so
no tensor here requires grad.

Where the JAX package vmaps a per-partition function over the partition
axis, this module writes the partition axis out as a batch dimension:
every tensor of the step carries it, gathers and scatters index a
flattened partition×row axis, and one kernel launch covers all partitions.

Two schedules run the same arithmetic. The unsplit step (`_step_impl`)
exchanges each payload where it is produced. The split-phase step
(`_step_impl_split`, ``PipeConfig.overlap``) cuts each layer's SpMM into a
boundary phase and an interior phase and starts the exchange between
them; in eager PyTorch the order of statements is the schedule, so the
exchange is started (`backend.start_exchange`) after the boundary phase
and waited on (`handle.wait()`) after the interior phase, before its
first consumer. On the card the sim backend runs the exchange as a copy
on a side CUDA stream and the SPMD backend as an asynchronous NCCL
collective, the paper's second stream either way; the split step equals
the unsplit one bitwise.

The step runs variants vanilla / pipegcn / -g / -f / -gf, k-step FIFOs
(``staleness_steps``) and the fused deferred exchange, with the "coo",
"blocksparse" and "fused" engines, every boundary wire codec
(``PipeConfig.wire``: f32, bf16, int8, int4, auto; ``core/codec.py``)
and feature slicing (``slice_boundary``: a sliced layer ships its
post-transform rows). Every exchanged payload is encoded before the
exchange and decoded after it, in both schedules.

Under ``PipeConfig.guard_exchange`` every wire carries a per-row checksum
column (`codec.ChecksumCodec`); the receiver verifies it, rows that fail
keep their stale buffer entry (one extra step of staleness), and the
"es" buffer counts each (direction, layer, peer) exchange's consecutive
fallbacks. `train_step(..., step_idx, faults)` injects a compiled
`faults.FaultTables` plan into the encoded wires (`faults.apply_faults`).
The guard and faults run the unsplit step.

State layout (per layer ℓ; widths follow `payload_widths`: the layer input
width, or the output width of a sliced layer; n is the number of
partitions a backend holds: P on the sim backend, n_local on a rank):
  feat_buf[ℓ] : (n, P*slot, F_ℓ)   stale boundary features   (Eq. 3 h^(t-1))
  grad_buf[ℓ] : (n, max_inner, F_ℓ) stale boundary-gradient contributions,
                already exchanged and scattered to owner rows (Eq. 4 δ^(t-1))
  es          : (n, 2, L, P) int32 consecutive fallbacks per (direction,
                layer, peer), under ``guard_exchange`` only
With ``staleness_steps`` k > 1 each feat/grad buffer gains a leading FIFO
axis of k; "es" never does.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.codec import (fused_exchange_encoded, make_codec,
                                    start_fused_exchange_encoded)
from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.core.faults import BWD, FWD, apply_faults
from repro_torch.device import exact_f32_matmul, resolve_device
from repro_torch.graph.halo import PartitionedGraph, extract_partition_tiles
from repro_torch.graph.reorder import TILE_ENGINES
from repro_torch.kernels.aggregate import get_engine
from repro_torch.kernels.gcn_spmm import (SCHED_CHUNK, TILE, SplitSpec,
                                          run_pointers, tile_schedules)


class Topology(NamedTuple):
    """Device-ready padded partition topology (leading axis = partition).

    The COO fields are always present; the `tile_*` fields (block-sparse
    streams, see repro_torch.kernels.gcn_spmm) are attached by
    ``topology_from(pg, with_tiles=True)`` and stay None otherwise. The run
    pointers ``tile_row_ptr`` / ``tile_col_ptr`` index the row-sorted
    forward stream and the column-sorted transpose stream per output block.
    ``tile_work`` / ``tile_items`` (``tile_t_work`` / ``tile_t_items`` for
    the transpose) are the nonzero-tile work lists and work items of
    ``gcn_spmm.tile_schedule`` that the spmm and fused kernels walk.
    """

    edge_row: torch.Tensor    # (P, max_nnz) int32
    edge_col: torch.Tensor    # (P, max_nnz) int32 (combined-array columns)
    edge_w: torch.Tensor      # (P, max_nnz) f32
    send_idx: torch.Tensor    # (P, P, slot) int32
    send_mask: torch.Tensor   # (P, P, slot) bool
    inner_mask: torch.Tensor  # (P, max_inner) bool
    tile_rows: torch.Tensor | None = None     # (P, n_tiles) int32
    tile_cols: torch.Tensor | None = None     # (P, n_tiles) int32
    tile_vals: torch.Tensor | None = None     # (P, n_tiles, T, T) f32
    tile_t_out: torch.Tensor | None = None    # (P, n_tiles) int32
    tile_t_in: torch.Tensor | None = None     # (P, n_tiles) int32
    tile_t_perm: torch.Tensor | None = None   # (P, n_tiles) int32
    tile_row_ptr: torch.Tensor | None = None  # (P, nrb+1) int32
    tile_col_ptr: torch.Tensor | None = None  # (P, ncb+1) int32
    tile_work: torch.Tensor | None = None     # (P, W, 2) int32
    tile_items: torch.Tensor | None = None    # (P, I, 5) int32
    tile_t_work: torch.Tensor | None = None   # (P, W', 2) int32
    tile_t_items: torch.Tensor | None = None  # (P, I', 5) int32

    @property
    def num_parts(self) -> int:
        return self.send_idx.shape[-2]

    @property
    def max_inner(self) -> int:
        return self.inner_mask.shape[-1]

    @property
    def slot(self) -> int:
        return self.send_idx.shape[-1]

    @property
    def halo_size(self) -> int:
        return self.num_parts * self.slot

    def with_schedules(self, chunk: int = SCHED_CHUNK,
                       walk_all: bool = False) -> "Topology":
        """The same topology with the spmm kernels' schedules rebuilt from
        its tile streams (`gcn_spmm.tile_schedules`: work items of at most
        `chunk` nonzero tiles; every slot walked with `walk_all`)."""
        host = SimpleNamespace(**{
            k: getattr(self, "tile_" + k).cpu().numpy()
            for k in ("rows", "cols", "vals", "t_out", "t_in", "t_perm")})
        sch = tile_schedules(host, self.max_inner,
                             self.max_inner + self.halo_size, chunk, walk_all)
        return self._replace(**{
            "tile_" + k: torch.from_numpy(v).to(self.tile_vals.device)
            for k, v in sch.items()})

    def to(self, dtype: torch.dtype) -> "Topology":
        """The same topology with its float fields (edge and tile weights)
        in `dtype` — e.g. float64 for the exactness tests."""
        return self._replace(**{
            k: v.to(dtype) for k, v in self._asdict().items()
            if v is not None and v.is_floating_point()})


class ShardedData(NamedTuple):
    """Per-partition node data (leading axis = partition)."""

    x: torch.Tensor           # (P, max_inner, F)
    labels: torch.Tensor      # (P, max_inner) int or (P, max_inner, C) f32
    train_mask: torch.Tensor  # (P, max_inner) bool
    eval_mask: torch.Tensor   # (P, max_inner) bool (val or test)


def topology_from(pg: PartitionedGraph, with_tiles: bool = False,
                  device="cuda") -> Topology:
    """Lift a PartitionedGraph to tensors on `device`; `with_tiles=True`
    also extracts the block-sparse tile streams, their run pointers and
    the kernels' schedules."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tiles = {}
    if with_tiles:
        pt = extract_partition_tiles(pg)
        nrb = -(-pg.max_inner // TILE)
        ncb = -(-pg.combined // TILE)
        tiles = dict(tile_rows=t(pt.rows), tile_cols=t(pt.cols),
                     tile_vals=t(pt.vals), tile_t_out=t(pt.t_out),
                     tile_t_in=t(pt.t_in), tile_t_perm=t(pt.t_perm),
                     tile_row_ptr=t(run_pointers(pt.rows, nrb)),
                     tile_col_ptr=t(run_pointers(pt.t_out, ncb)),
                     **{"tile_" + k: t(v) for k, v in tile_schedules(
                         pt, pg.max_inner, pg.combined).items()})
    return Topology(
        edge_row=t(pg.edge_row), edge_col=t(pg.edge_col),
        edge_w=t(pg.edge_w), send_idx=t(pg.send_idx),
        send_mask=t(pg.send_mask), inner_mask=t(pg.inner_mask), **tiles)


def shard_data(pg: PartitionedGraph, x, labels, train_mask, eval_mask,
               device="cuda") -> ShardedData:
    dev = resolve_device(device)

    def pack(a, dtype=None):
        a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
        return torch.from_numpy(pg.pack_nodes(a)).to(dev)

    return ShardedData(x=pack(x, np.float32), labels=pack(labels),
                       train_mask=pack(train_mask), eval_mask=pack(eval_mask))


def params_from_jax(np_params: dict, device) -> dict:
    """Carry the JAX package's parameters (``w{ℓ}`` of shape (fan_in, fout),
    ``b{ℓ}`` of shape (fout,), as numpy arrays) into the port: the layouts
    are the same, so both packages compute the same function."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev)
            for k, v in np_params.items()}


def split_spec_from(pg: PartitionedGraph, tile: int = TILE) -> SplitSpec | None:
    """The split-phase schedule spec of a partitioned graph, or None when
    the split is infeasible (P = 1, no sends, or boundary rows not
    clustered into a tail: see ``graph.halo.boundary_row_split``). The
    group sizes come from the same memoized ``extract_partition_tiles``
    call that ``topology_from(pg, with_tiles=True)`` uses, so the phase cut
    and the padded tile streams agree by construction."""
    pt = extract_partition_tiles(pg, tile)
    if pt.fwd_bnd is None:
        return None
    return SplitSpec(row_tail=pt.b0 * tile, col_tail=pt.hb0 * tile,
                     fwd_bnd_tiles=pt.fwd_bnd, t_bnd_tiles=pt.t_bnd)


# ----------------------------------------------------------------------
# Boundary gather / scatter over the partition axis
# ----------------------------------------------------------------------

def _gather_send(h, send_idx, send_mask):
    """(n, max_inner, F) -> (n, P, slot, F): row send_idx[p, j, k] of
    partition p, the payload partition p sends to peer j (0 where masked)."""
    p, peers, slot = send_idx.shape
    rows = torch.arange(p, device=h.device)[:, None]
    out = h[rows, send_idx.reshape(p, -1).long()]
    out = out.reshape(p, peers, slot, h.shape[-1])
    return torch.where(send_mask[..., None], out, 0.0)


def _gather_send_tail(h_tail, send_idx, send_mask, row_tail: int):
    """`_gather_send` reading from the boundary phase's rows only: `h_tail`
    holds rows [row_tail, max_inner) of the layer output. Every real send
    index is >= row_tail by construction of the split; masked slots carry
    index 0, which is clamped onto the first tail row and then zeroed by
    the mask, as `_gather_send` zeroes them."""
    return _gather_send(h_tail, torch.clamp(send_idx - row_tail, min=0),
                        send_mask)


def _scatter_recv(contrib, send_idx, send_mask, max_inner: int):
    """(n, P, slot, F) received gradient blocks -> (n, max_inner, F):
    partition p adds recv[p, j, k] into its row send_idx[p, j, k].

    Deterministic on every device: one `index_add_` per peer j, in peer
    order, and within one peer's block every real slot names a distinct
    row (a node is sent to a peer once) while masked pad slots land in a
    spare row per partition, so no launch adds twice to one element and
    the CUDA atomics have no order to vary. On the CPU the sums are the
    sequential ones of a single `index_add_` over all slots."""
    p, peers, slot, f = contrib.shape
    rows = (torch.where(send_mask, send_idx.long(), max_inner)
            + (max_inner + 1) * torch.arange(
                p, device=contrib.device)[:, None, None])
    out = contrib.new_zeros(p * (max_inner + 1), f)
    for j in range(peers):
        out.index_add_(0, rows[:, j].reshape(-1),
                       contrib[:, j].reshape(p * slot, f))
    return out.reshape(p, max_inner + 1, f)[:, :max_inner].contiguous()


def _scatter_invalid_rows(inv, send_idx, max_inner: int):
    """(n, P, slot) invalid-contribution mask -> (n, max_inner) owner rows
    whose `_scatter_recv` sum is incomplete (any contributing slot was
    invalid). Those rows fall back to the stale buffer wholesale: a
    partial sum is wrong data, not one-step-stale data. An integer max
    scatter, deterministic on every device."""
    p = send_idx.shape[0]
    flat = (send_idx.reshape(p, -1).long()
            + max_inner * torch.arange(p, device=inv.device)[:, None])
    out = torch.zeros(p * max_inner, dtype=torch.int32, device=inv.device)
    out.scatter_reduce_(0, flat.reshape(-1),
                        inv.reshape(-1).to(torch.int32), "amax")
    return out.reshape(p, max_inner) > 0


def _part_ids(backend, n: int) -> list[int]:
    """Global partition ids of the backend's leading-axis slots: the
    SPMD rank's own, else all n of the sim backend."""
    ids = getattr(backend, "part_ids", None)
    return ids() if ids is not None else list(range(n))


# ----------------------------------------------------------------------
# Fused deferred exchange: per-layer payloads packed along the feature
# axis and exchanged once (the exchange is pure data movement, so packing
# commutes with it exactly).
# ----------------------------------------------------------------------

def pack_payloads(payloads):
    """Per-layer (n, P, slot, F_l) sends -> one (n, P, slot, ΣF_l)."""
    return torch.cat(payloads, dim=-1)


def unpack_payloads(packed, widths):
    """Inverse of `pack_payloads` given the per-layer width table."""
    return list(torch.split(packed, list(widths), dim=-1))


# ----------------------------------------------------------------------
# Hierarchical exchange: P partitions on P // n_local ranks. Partition p
# lives on rank p // n_local. Per rank, the send tensor s[l, j] is the
# payload from co-resident partition l to global partition j. The
# exchange blocks the global P axis as (n_dev, n_local): the two local
# axes are permuted by reshapes and transposes, and only the device axis
# crosses the wire, in one all_to_all of (n_local × n_local) blocks.
# ----------------------------------------------------------------------

def _hier_pack(s, n_local: int):
    """(n_local, P, ...) send tensor -> (n_dev, l_src, l_dst, ...) blocks,
    device-major along axis 0 (the only axis the all_to_all splits)."""
    n_dev = s.shape[1] // n_local
    a = s.reshape((n_local, n_dev, n_local) + tuple(s.shape[2:]))
    return a.transpose(0, 1)


def _hier_unpack(recv, n_local: int):
    """(n_dev, l_src, l_dst, ...) received blocks -> (n_local, P, ...): row
    l holds the payloads addressed to co-resident partition l, indexed by
    global sender id."""
    n_dev = recv.shape[0]
    r = recv.movedim(2, 0)
    return r.reshape((n_local, n_dev * n_local) + tuple(recv.shape[3:]))


def hierarchical_exchange_host(S):
    """Single-process evaluation of the hierarchical exchange on a global
    (n_dev, n_local, P, ...) payload with the device axis explicit: the
    all_to_all is replaced by its definition (device d's chunk j lands on
    device j at position d, a transpose of the two device axes)."""
    n_local = S.shape[1]
    blocks = torch.stack([_hier_pack(s, n_local) for s in S])
    recv = blocks.transpose(0, 1)
    return torch.stack([_hier_unpack(r, n_local) for r in recv])


def flat_exchange_reference(S):
    """The flat global exchange R[i, j] = S[j, i] over global partition ids,
    reshaped to the same (n_dev, n_local, P, ...) layout: the
    specification the hierarchical exchange must match."""
    n_dev, n_local, p = S.shape[:3]
    flat = S.reshape((n_dev * n_local, p) + tuple(S.shape[3:]))
    return flat.transpose(0, 1).reshape(S.shape)


# ----------------------------------------------------------------------
# Backends: the sync points. An exchange is either blocking (`exchange`,
# the unsplit step) or started and waited on (`start_exchange` returns a
# handle whose `wait()` gives the received payload: the split step).
# ----------------------------------------------------------------------

class _Done:
    """The handle of an exchange that completed when it was started."""

    def __init__(self, recv):
        self._recv = recv

    def wait(self):
        return self._recv


class _Then:
    """A handle whose result is `finish` applied to another handle's."""

    def __init__(self, handle, finish):
        self._handle, self._finish = handle, finish

    def wait(self):
        return self._finish(self._handle.wait())


class _SideStreamCopy:
    """An exchange copy running on a side CUDA stream; `wait()` makes the
    caller's stream wait for it."""

    def __init__(self, recv, done):
        self._recv, self._done = recv, done

    def wait(self):
        torch.cuda.current_stream(self._recv.device).wait_event(self._done)
        return self._recv


class _Collective:
    """An asynchronous torch.distributed collective and how to read its
    output once it has landed."""

    def __init__(self, work, out, finish):
        self._work, self._out, self._finish = work, out, finish

    def wait(self):
        self._work.wait()
        return self._finish(self._out)


class _ExchangeBase:
    """The fused exchange and the schedule hook, layered on each backend's
    `exchange` / `start_exchange`."""

    def fused_exchange(self, payloads):
        """[self.exchange(p) for p in payloads], in one exchange."""
        recv = self.exchange(pack_payloads(payloads))
        return unpack_payloads(recv, [int(p.shape[-1]) for p in payloads])

    def start_fused_exchange(self, payloads):
        """`fused_exchange` started now; the handle's `wait()` gives the
        per-layer payloads."""
        widths = [int(p.shape[-1]) for p in payloads]
        return _Then(self.start_exchange(pack_payloads(payloads)),
                     lambda recv: unpack_payloads(recv, widths))

    def note(self, event):
        """A schedule event of the step (a phase launch); recorded by
        `trace_utils.RecordingBackend`, ignored otherwise."""


class SimBackend(_ExchangeBase):
    """Partitions as the leading axis on a single device: the exchanges
    are transposes, and the reductions over partitions (weight gradients,
    loss) are sums over the leading axis. The counter
    ``exchange.side_copies`` counts the exchange copies started on a side
    CUDA stream; ``exchange.bytes`` the bytes handed to every exchange."""

    def __init__(self):
        self._side = None       # the side CUDA stream, made at first use

    def exchange(self, s):
        # s: (P_sender, P_receiver, slot, F); R[i, j] = S[j, i]
        spans.count("exchange.bytes", s.numel() * s.element_size())
        return s.transpose(0, 1)

    def start_exchange(self, s):
        """Start the exchange of `s`. On the card the transpose copy runs
        on a side stream, ordered after the work that produced `s`, so
        the compute stream goes on with the interior phase; on the CPU it
        completes here."""
        if not s.is_cuda:
            return _Done(self.exchange(s))
        spans.count("exchange.bytes", s.numel() * s.element_size())
        compute = torch.cuda.current_stream(s.device)
        if self._side is None:
            self._side = torch.cuda.Stream(s.device)   # from torch's pool
        side = self._side
        # allocated on the compute stream, which reads it after wait()
        recv = torch.empty((s.shape[1], s.shape[0]) + tuple(s.shape[2:]),
                           dtype=s.dtype, device=s.device)
        ready = torch.cuda.Event()
        ready.record(compute)
        side.wait_event(ready)
        with torch.cuda.stream(side):
            with spans.span("repro.exchange", device=True):
                recv.copy_(s.transpose(0, 1))
            done = torch.cuda.Event()
            done.record(side)
        s.record_stream(side)   # s's memory is not reused before the copy
        spans.count("exchange.side_copies")
        return _SideStreamCopy(recv, done)

    def psum(self, x):
        """Sum of per-partition values (n, ...) over all partitions."""
        return x.sum(0)

    def psum_scalar(self, x):
        """Sum of a per-partition vector (n,) over all partitions."""
        return x.sum()

    def all_ok(self, ok):
        """A verdict every rank shares (one rank here)."""
        return ok

    def dropout_mask(self, generator, rate, shape):
        keep = torch.rand(shape, generator=generator,
                          device=generator.device) >= rate
        return keep.to(torch.float32) / (1.0 - rate)


class SpmdBackend(_ExchangeBase):
    """One process per rank of a torch.distributed process group, each
    holding partitions [rank·n_local, (rank+1)·n_local) as its leading
    axis (the sim backend's layout, cut into device-major slices).

    The exchange is one ``all_to_all_single``: flat for n_local = 1,
    hierarchical otherwise (co-resident pairs are permuted locally, only
    the device axis crosses the wire). `start_exchange` issues it with
    ``async_op=True``: on the card NCCL runs it on its own stream, ordered
    after the producer, and `wait()` orders the caller's stream after it.

    The reductions gather every rank's per-partition values and sum them
    in global partition order, as the sim backend sums its leading axis:
    the result is bitwise the sim backend's and the same on every rank,
    where an all_reduce would sum in its ring's order."""

    def __init__(self, n_local: int = 1, group=None, rank: int | None = None,
                 world_size: int | None = None):
        import torch.distributed as dist
        self.group = group
        self.n_local = n_local
        self.rank = dist.get_rank(group) if rank is None else rank
        self.world_size = (dist.get_world_size(group) if world_size is None
                           else world_size)

    @property
    def num_parts(self) -> int:
        return self.world_size * self.n_local

    def part_ids(self) -> list[int]:
        """Global partition ids of this rank's leading-axis slots."""
        return [self.rank * self.n_local + l for l in range(self.n_local)]

    def _a2a(self, s, async_op: bool):
        import torch.distributed as dist
        if self.n_local == 1:
            send = s[0].contiguous()        # (P, slot, F)

            def finish(out):
                return out[None]
        else:
            send = _hier_pack(s, self.n_local).contiguous()

            def finish(out):
                return _hier_unpack(out, self.n_local)
        out = torch.empty_like(send)
        work = dist.all_to_all_single(out, send, group=self.group,
                                      async_op=async_op)
        return work, out, finish

    def exchange(self, s):
        # s: (n_local, P, slot, F); R[l, j] = payload of global partition
        # j to this rank's partition l
        spans.count("exchange.bytes", s.numel() * s.element_size())
        _, out, finish = self._a2a(s, async_op=False)
        return finish(out)

    def start_exchange(self, s):
        spans.count("exchange.bytes", s.numel() * s.element_size())
        work, out, finish = self._a2a(s, async_op=True)
        return _Collective(work, out, finish)

    def gather_parts(self, x):
        """(n_local, ...) on every rank -> the global (P, ...) tensor, in
        global partition order, on every rank."""
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, 0)

    def barrier(self):
        """Wait until every rank of the group gets here."""
        import torch.distributed as dist
        dist.barrier(group=self.group)

    def psum(self, x):
        return self.gather_parts(x).sum(0)

    def psum_scalar(self, x):
        return self.gather_parts(x).sum()

    def all_ok(self, ok):
        return self.gather_parts(ok.reshape(1).to(torch.int32)).min() > 0

    def dropout_mask(self, generator, rate, shape):
        """One generator stream per global partition id, so the mask a
        partition sees does not depend on how partitions map onto ranks.
        Every rank draws the same base seed from its copy of `generator`."""
        dev = generator.device
        with spans.sync("dropout_seed"):
            base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=dev))
        keep = torch.stack([
            torch.rand(tuple(shape[1:]), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           base + pid)) >= rate
            for pid in self.part_ids()])
        return keep.to(torch.float32) / (1.0 - rate)


# ----------------------------------------------------------------------
# Losses (masked, globally normalized)
# ----------------------------------------------------------------------

def _ce_loss_and_grad(logits, labels, mask, total):
    """Masked softmax cross-entropy; returns (per-partition sums, dlogits)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss_sums = torch.sum((lse - ll) * mask, dim=1)
    probs = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(
        labels.long(), logits.shape[-1]).to(logits.dtype)
    dlogits = (probs - onehot) * mask[..., None] / total
    return loss_sums, dlogits


def _bce_loss_and_grad(logits, labels, mask, total):
    """Masked multi-label sigmoid BCE (Yelp-style); total counts node·class."""
    z, y = logits, labels.to(logits.dtype)
    per = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    loss_sums = torch.sum(per * mask[..., None], dim=(1, 2))
    dlogits = (torch.sigmoid(z) - y) * mask[..., None] / total
    return loss_sums, dlogits


# ----------------------------------------------------------------------
# The module
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PipeGCN:
    """Partition-parallel GCN with pipelined communication.

    Parameters, pipeline buffers and the dropout generator are explicit
    arguments, as in the JAX package, so a step is a function of its
    inputs. `split` is the split-phase spec of the graph
    (``split_spec_from(pg)`` or ``GraphDataPipeline.split_spec()``); None
    runs every step unsplit whatever ``PipeConfig.overlap`` says.
    """

    model: ModelConfig
    pipe: PipeConfig
    split: SplitSpec | None = None

    def __post_init__(self):
        get_engine(self.model.agg)      # unknown or unported engines raise

    # ---------------- parameters & state ----------------

    def init_params(self, generator: torch.Generator,
                    dtype=torch.float32) -> dict:
        """Glorot-scaled normal weights (fan_in × fout) and zero biases,
        drawn on the generator's device."""
        dev = generator.device
        params = {}
        for ell, (fin, fout) in enumerate(self.model.layer_dims()):
            fan_in = 2 * fin if self.model.kind == "sage" else fin
            scale = float(np.sqrt(2.0 / (fan_in + fout)))
            params[f"w{ell}"] = torch.randn(
                fan_in, fout, generator=generator, device=dev,
                dtype=dtype) * scale
            params[f"b{ell}"] = torch.zeros(fout, device=dev, dtype=dtype)
        return params

    def init_buffers(self, topo: Topology, dtype=torch.float32) -> dict:
        """Zero pipeline state (Alg. 1 line 6: boundary features start at
        0) for the partitions `topo` holds (all P, or a rank's n_local).
        With staleness_steps k > 1 each buffer is a FIFO along a new
        leading axis of size k (slot 0 = oldest = consumed). Under
        `guard_exchange` the dict gains "es": int32 consecutive-fallback
        counters of shape (n, 2, L, P), (direction, layer, peer) per
        partition, with no FIFO axis."""
        n = topo.send_idx.shape[0]
        k = self.pipe.staleness_steps
        lead = ((k,) if k > 1 else ()) + (n,)
        dev = topo.send_idx.device
        feat, grad = [], []
        for w in self.payload_widths(topo):
            feat.append(torch.zeros(lead + (topo.halo_size, w), dtype=dtype,
                                    device=dev))
            grad.append(torch.zeros(lead + (topo.max_inner, w), dtype=dtype,
                                    device=dev))
        out = {"feat": tuple(feat), "grad": tuple(grad)}
        if self.pipe.guard_exchange:
            out["es"] = torch.zeros(
                (n, 2, self.model.num_layers, topo.num_parts),
                dtype=torch.int32, device=dev)
        return out

    # ---------------- pipeline-buffer semantics ----------------

    def _consume_buffer(self, buf):
        """The stale state a step reads: t-k (FIFO head) or t-1 (plain/EMA)."""
        return buf[0] if self.pipe.staleness_steps > 1 else buf

    def _update_buffer(self, buf, fresh, smooth: bool):
        """Next-step buffer from the freshly exchanged payload: FIFO push,
        EMA (γ·old + (1−γ)·fresh), or plain replacement."""
        if self.pipe.staleness_steps > 1:
            return torch.cat([buf[1:], fresh[None]], dim=0)
        if smooth:
            return self.pipe.gamma * buf + (1 - self.pipe.gamma) * fresh
        return fresh

    def _update_buffer_guarded(self, buf, fresh, smooth: bool, valid):
        """`_update_buffer` with per-row fallback (guard_exchange): rows of
        `fresh` whose checksum failed keep their previous value — the FIFO
        re-pushes its newest entry, EMA / replace keep the old row — so a
        lost payload is one extra step of staleness. `valid=None` (guard
        off) is `_update_buffer`; an all-True mask gives its bits (a
        select, never arithmetic)."""
        if valid is None:
            return self._update_buffer(buf, fresh, smooth)
        v = valid[..., None]
        if self.pipe.staleness_steps > 1:
            pushed = torch.where(v, fresh, buf[-1])
            return torch.cat([buf[1:], pushed[None]], dim=0)
        if smooth:
            upd = self.pipe.gamma * buf + (1 - self.pipe.gamma) * fresh
            return torch.where(v, upd, buf)
        return torch.where(v, fresh, buf)

    # ---------------- shared layer math ----------------

    @property
    def engine(self):
        """The aggregation engine selected by ``ModelConfig.agg``."""
        return get_engine(self.model.agg)

    def _agg_slice(self, topo: Topology):
        """The Topology fields the selected engine consumes."""
        engine = self.engine
        tslice = tuple(getattr(topo, f) for f in engine.fields)
        if any(t is None for t in tslice):
            raise ValueError(
                f"aggregation engine {engine.name!r} needs Topology fields "
                f"{engine.fields}, but some are None — build the topology "
                "with topology_from(pg, with_tiles=True) or "
                f"GraphDataPipeline.build(..., agg={engine.name!r})")
        return tslice

    def _split_active(self) -> SplitSpec | None:
        """The SplitSpec the step runs with, or None for unsplit, gated as
        in the JAX package: "none" and a missing spec mean unsplit;
        "split-phase" splits for every engine; "auto" splits only for the
        engines that consume tile streams (for COO the split is pure
        masking overhead). Feature slicing disables the split (the sliced
        send exists only after the dense transform, so there is no
        boundary-first phase to overlap), and so does the guarded
        exchange (the split step has no validity-mask path)."""
        if (self.pipe.overlap == "none" or self.split is None
                or self.pipe.slice_boundary or self.pipe.guard_exchange):
            return None
        if self.pipe.overlap == "split-phase":
            return self.split
        return self.split if self.engine.name in TILE_ENGINES else None

    def sliced_layers(self, topo: Topology) -> frozenset:
        """Layers whose boundary exchange ships the post-transform width.

        Empty unless `PipeConfig.slice_boundary`. A layer is sliced when
        the train-mode base ordering picks transform-first for it and
        fout <= fin (slicing a widening layer would grow the wire). Layer 0
        never slices: its payload is the raw input features. Computed from
        `_base_orders(train=True)` only, so the sliced set — and with it
        every buffer width — is the same for train and eval steps."""
        if not self.pipe.slice_boundary:
            return frozenset()
        dims = self.model.layer_dims()
        orders = self._base_orders(topo, train=True)
        return frozenset(
            ell for ell in range(1, self.model.num_layers)
            if orders[ell] == "transform-first"
            and dims[ell][1] <= dims[ell][0])

    def payload_widths(self, topo: Topology) -> tuple[int, ...]:
        """Per-layer feature width of the boundary exchange payload: fin,
        or fout for sliced layers. Stale buffers, wire-format resolution
        and the byte accounting all key off this table."""
        dims = self.model.layer_dims()
        sl = self.sliced_layers(topo)
        return tuple(dims[ell][1] if ell in sl else dims[ell][0]
                     for ell in range(self.model.num_layers))

    def wire_codecs(self, topo: Topology) -> tuple:
        """Per-layer boundary codec (`repro_torch.core.codec`) the step
        encodes with. A concrete `PipeConfig.wire` applies to every layer;
        "auto" picks per layer by wire bytes over the payload widths
        (`analysis.cost.choose_wire_formats`; int4 is explicit-only).
        Under `guard_exchange` every codec is wrapped in a ChecksumCodec
        (one extra wire column per row, verified on decode)."""
        L = self.model.num_layers
        g = self.pipe.guard_exchange
        if self.pipe.wire != "auto":
            return (make_codec(self.pipe.wire, self.pipe.wire_block,
                               guard=g),) * L
        from repro_torch.analysis.cost import choose_wire_formats
        fmts = choose_wire_formats(self.payload_widths(topo),
                                   block=self.pipe.wire_block)
        return tuple(make_codec(f, self.pipe.wire_block, guard=g)
                     for f in fmts)

    def _base_orders(self, topo: Topology, train: bool = True,
                     fused: bool | None = None) -> tuple[str, ...]:
        """Per-layer matmul ordering: forced, or "auto" through the static
        FLOP model fed the shard's effective sparse work (n_tiles·T² for
        the tile engines, the padded COO length otherwise), as the JAX
        package's `_base_orders`. `fused` overrides whether the fused
        kernels are priced (default: the engine is "fused"); the
        split-phase step runs the fused engine through the composed phased
        path and passes fused=False. Under `slice_boundary` each order is
        also charged the wire bytes it ships (transform-first ships the
        sliced fout width), with formats resolved on the unsliced widths:
        the sliced set is itself derived from this choice."""
        mo = self.model.matmul_order
        L = self.model.num_layers
        if mo != "auto":
            return (mo,) * L
        combined = topo.max_inner + topo.halo_size
        if self.engine.name in TILE_ENGINES and topo.tile_rows is not None:
            nnz_eff = [topo.tile_rows.shape[-1] * TILE * TILE] * L
        else:
            nnz_eff = [topo.edge_row.shape[-1]] * L
        if fused is None:
            fused = self.engine.name == "fused"
        from repro_torch.analysis.cost import (DEFAULT_FLOPS_PER_WIRE_BYTE,
                                               choose_gcn_orders,
                                               choose_wire_formats,
                                               wire_bytes_per_row)
        kw = {}
        if self.pipe.slice_boundary:
            block = self.pipe.wire_block
            if self.pipe.wire == "auto":
                fmts = choose_wire_formats(
                    [f for f, _ in self.model.layer_dims()], block=block)
            else:
                fmts = (self.pipe.wire,) * L
            kw = dict(
                slot_rows=float(topo.halo_size),
                wire_bytes_fn=lambda ell, f: wire_bytes_per_row(
                    fmts[ell], f, block),
                slice_boundary=True,
                comm_flops_per_byte=DEFAULT_FLOPS_PER_WIRE_BYTE)
        return choose_gcn_orders(self.model.layer_dims(), topo.max_inner,
                                 combined, nnz_eff, train=train,
                                 fused=fused, tile=TILE, **kw)

    def layer_orders(self, topo: Topology, train: bool = True,
                     fused: bool | None = None) -> tuple[str, ...]:
        """Per-layer matmul ordering the step runs with: `_base_orders`,
        with every sliced layer forced to transform-first in every mode
        (its exchange and stale buffers carry the post-transform width, so
        the order behind them must not drift between train and eval or
        across `fused` overrides)."""
        orders = self._base_orders(topo, train=train, fused=fused)
        sl = self.sliced_layers(topo)
        return tuple("transform-first" if ell in sl else o
                     for ell, o in enumerate(orders))

    def step_orders(self, topo: Topology, train: bool = True):
        """The orders the step runs with: `layer_orders`, priced unfused
        under the split-phase schedule."""
        split = self._split_active() is not None
        return self.layer_orders(topo, train=train,
                                 fused=False if split else None)

    def _layer_forward(self, tslice, w, b, h_prev, halo, drop_mask,
                       order: str = "aggregate-first",
                       fuse_relu: bool = False, with_z: bool = True):
        """One GCN/SAGE layer over all partitions. Returns (u, (comb, z)):
        comb (n, combined, fin) is the [inner; halo] input after dropout, z
        the aggregation residual (None under transform-first or at eval).
        With `fuse_relu` u comes back activated: inside the fused kernel's
        epilogue for a GCN layer under aggregate-first (SAGE adds its self
        term after the kernel), as a plain op otherwise."""
        max_inner = h_prev.shape[1]
        fin = h_prev.shape[-1]
        comb = torch.cat([h_prev, halo], dim=1)
        if drop_mask is not None:
            comb = comb * drop_mask
        sage = self.model.kind == "sage"
        w1 = w[:fin] if sage else w
        in_kernel_relu = False
        if order == "transform-first":
            u = self.engine.spmm(tslice, comb @ w1, max_inner) + b
            z = None
        else:
            in_kernel_relu = fuse_relu and not sage
            u, z = self.engine.aggregate_transform(
                tslice, comb, w1, b, max_inner, relu=in_kernel_relu,
                with_z=with_z)
        if sage:
            u = u + comb[:, :max_inner] @ w[fin:]
        if fuse_relu and not in_kernel_relu:
            u = torch.relu(u)
        return u, (comb, z)

    def _layer_backward(self, tslice, w, du, comb, z, drop_mask, max_inner,
                        order: str = "aggregate-first",
                        need_dcomb: bool = True):
        """Manual VJP of one layer over all partitions. Returns (per-
        partition gW (n, fan_in, fout), dH_inner_local, dB_halo); the
        d-terms are None when `need_dcomb=False` (layer 0 — Alg. 1 stops
        the backward there, though transform-first still needs Pᵀ·du for
        its weight gradient)."""
        combined = comb.shape[1]
        fin = comb.shape[-1]
        sage = self.model.kind == "sage"
        w1 = w[:fin] if sage else w
        inner_t = comb[:, :max_inner].transpose(1, 2)
        if order == "transform-first":
            dhw = self.engine.spmm_t(tslice, du, combined)
            gw = comb.transpose(1, 2) @ dhw     # = zᵀ·du without z
            if sage:
                gw = torch.cat([gw, inner_t @ du], dim=1)
            if not need_dcomb:
                return gw, None, None
            dcomb = dhw @ w1.T
        else:
            gw = z.transpose(1, 2) @ du
            if sage:
                gw = torch.cat([gw, inner_t @ du], dim=1)
            if not need_dcomb:
                return gw, None, None
            dcomb = self.engine.aggregate_transform_t(tslice, du, w1,
                                                      combined)
        if sage:
            dcomb = torch.cat([dcomb[:, :max_inner] + du @ w[fin:].T,
                               dcomb[:, max_inner:]], dim=1)
        if drop_mask is not None:
            dcomb = dcomb * drop_mask
        return gw, dcomb[:, :max_inner], dcomb[:, max_inner:]

    def _loss(self, backend, logits, data):
        """Masked, globally normalized loss: (loss, dlogits)."""
        mask = data.train_mask.to(logits.dtype)
        count = backend.psum_scalar(torch.sum(mask, dim=1))
        if self.model.multilabel:
            count = count * self.model.num_classes
        total = torch.clamp(count, min=1.0)
        loss_fn = (_bce_loss_and_grad if self.model.multilabel
                   else _ce_loss_and_grad)
        loss_sums, dlogits = loss_fn(logits, data.labels, mask, total)
        return backend.psum_scalar(loss_sums) / total, dlogits

    # ---------------- forward/backward step ----------------

    def _step_impl(self, backend, topo: Topology, params, buffers, data,
                   generator, train: bool, step_idx=None, faults=None):
        """One step over the backend's partitions. Returns (loss, logits,
        grads, new_buffers); grads and new_buffers are None when
        `train=False`. Runs the split-phase step when the split is active
        and no faults are injected.

        `faults` (compiled FaultTables) injects drop / corrupt faults into
        the encoded wires at host step `step_idx`; under
        `pipe.guard_exchange` the decode verifies each row's checksum and
        failed rows fall back to their stale buffer entry
        (`_update_buffer_guarded`). `faults=None` runs the fault-free
        step."""
        sp = self._split_active()
        if sp is not None and faults is None:
            # the split step has no injection points; a faulted run takes
            # the unsplit body, whose numerics are the same
            return self._step_impl_split(backend, topo, params, buffers,
                                         data, generator, train, sp)
        L = self.model.num_layers
        dims = self.model.layer_dims()
        pipe = self.pipe
        P = topo.num_parts
        max_inner = topo.max_inner
        combined = max_inner + topo.halo_size
        n = topo.send_idx.shape[0]
        sage = self.model.kind == "sage"

        tslice = self._agg_slice(topo)
        send_idx, send_mask = topo.send_idx, topo.send_mask
        fuse = pipe.fused        # stale + fuse_exchange: deferred exchanges
        orders = self.layer_orders(topo, train=train)
        sliced = self.sliced_layers(topo)
        codecs = self.wire_codecs(topo)
        pw = self.payload_widths(topo)
        dropout_rate = self.model.dropout if train else 0.0
        guard = pipe.guard_exchange
        pids = _part_ids(backend, n) if faults is not None else None
        # per-layer peer verdicts (guard only): bool (n, P) per direction,
        # folded into the "es" consecutive-fallback counters
        feat_pv = [None] * L
        grad_pv = [None] * L

        h = data.x
        residuals = []
        new_feat = [None] * L
        pending_feat = []        # fused mode: per-layer wires, exchanged once
        feat_dtypes = []         # ... and their pre-encode dtypes

        def land(ell, recv, dtype):
            """Decode one received (n, P, slot, ·) feature wire to the
            (n, P·slot, pw) halo layout in the payload's `dtype`; under the
            guard also verify each row's checksum, returning the
            (n, P·slot) valid-row mask (None without the guard) and
            folding the per-peer verdict into `feat_pv`."""
            if guard:
                fresh, valid = codecs[ell].decode_checked(recv, pw[ell],
                                                          dtype)
                feat_pv[ell] = valid.all(dim=-1)
                vrows = valid.reshape(n, P * topo.slot)
            else:
                fresh = codecs[ell].decode(recv, pw[ell], dtype)
                vrows = None
            return fresh.reshape(n, P * topo.slot, pw[ell]), vrows

        def encode(ell, payload, direction):
            """Encode one payload and inject this step's faults into it."""
            wire = codecs[ell].encode(payload)
            if faults is not None:
                wire = apply_faults(wire, faults, step_idx, direction, ell,
                                    pids, guard)
            return wire

        def ship_feat(ell, rows):
            """Gather and encode one layer's (n, P, slot, pw) feature send
            from its (n, max_inner, pw) `rows`, exchange it (or queue it for
            the fused exchange), decode, and return the halo the layer
            consumes this step."""
            with spans.span("repro.exchange", device=True):
                payload = _gather_send(rows, send_idx, send_mask)
                wire = encode(ell, payload, FWD)
                if fuse:
                    # Stale mode: the exchange result is consumed only at
                    # t+1, so defer the wire into the packed exchange and
                    # read this step's halo straight from the pipeline state.
                    pending_feat.append(wire)
                    feat_dtypes.append(payload.dtype)
                    return self._consume_buffer(buffers["feat"][ell])
                fresh, vrows = land(ell, backend.exchange(wire), payload.dtype)
                if pipe.stale:
                    new_feat[ell] = self._update_buffer_guarded(
                        buffers["feat"][ell], fresh, pipe.smooth_feat, vrows)
                    return self._consume_buffer(buffers["feat"][ell])
                new_feat[ell] = buffers["feat"][ell]
                return fresh

        for ell in range(L):
            with spans.span(f"repro.step.fwd.L{ell}"):
                fin, _ = dims[ell]
                w, b = params[f"w{ell}"], params[f"b{ell}"]
                dm = None
                if dropout_rate > 0.0:
                    dm = backend.dropout_mask(generator, dropout_rate,
                                              (n, combined, fin))
                act = ell < L - 1
                fuse_relu = act and not train
                if ell in sliced:
                    # Sliced boundary (order forced transform-first): transform
                    # the inner rows first and ship the fout-wide rows; the
                    # consumer aggregates already-transformed halo rows. Dropout
                    # applies owner-side before the transform (a halo row
                    # carries its owner's inner-row mask), which equals the
                    # unsliced schedule at dropout 0.
                    w1 = w[:fin] if sage else w
                    h_in = h * dm[:, :max_inner] if dm is not None else h
                    hw = h_in @ w1
                    halo = ship_feat(ell, hw)
                    u = self.engine.spmm(tslice, torch.cat([hw, halo], dim=1),
                                         max_inner) + b
                    if sage:
                        u = u + h_in @ w[fin:]
                    if fuse_relu:
                        u = torch.relu(u)
                    # residual slot 0 holds the masked inner rows: the sliced
                    # backward needs h_in, never the full comb
                    residuals.append((h_in, None, u, dm))
                else:
                    halo = ship_feat(ell, h)
                    u, (comb, z) = self._layer_forward(
                        tslice, w, b, h, halo, dm, order=orders[ell],
                        fuse_relu=fuse_relu, with_z=train)
                    residuals.append((comb, z, u, dm))
                h = torch.relu(u) if act and not fuse_relu else u

        if fuse:
            # ONE exchange for all L layers' boundary features; the results
            # land in the t+1 buffers. Decoding restores each layer's own
            # pre-pack dtype.
            with spans.span("repro.exchange", device=True):
                recvs = fused_exchange_encoded(backend, pending_feat)
            for ell, recv in enumerate(recvs):
                with spans.span("repro.exchange", device=True):
                    fresh, vrows = land(ell, recv, feat_dtypes[ell])
                    new_feat[ell] = self._update_buffer_guarded(
                        buffers["feat"][ell], fresh, pipe.smooth_feat, vrows)

        logits = h
        with spans.span("repro.step.loss"):
            loss, dlogits = self._loss(backend, logits, data)
        if not train:
            return loss, logits, None, None

        # -- manual backward (Alg. 1 lines 17–30) --------------------------
        grads = {}
        new_grad = [None] * L
        pending_grad = []        # fused mode: (ell, wire, dtype), one exchange

        def land_grad(ell, recv, dtype):
            """Decode one received gradient wire and scatter it to owner
            rows; returns (contribution, valid owner rows or None). Under
            the guard, rows failing their checksum are zeroed by a select
            (a corrupt row may decode to NaN) before the scatter-add, and
            every owner row any of them touched is marked invalid; the
            per-peer verdict lands in `grad_pv` (masked pad slots carry no
            data and are exempt)."""
            if not guard:
                return _scatter_recv(codecs[ell].decode(recv, pw[ell], dtype),
                                     send_idx, send_mask, max_inner), None
            db_recv, valid = codecs[ell].decode_checked(recv, pw[ell], dtype)
            inv = ~valid & send_mask
            grad_pv[ell] = ~inv.any(dim=-1)
            db_recv = torch.where(valid[..., None], db_recv,
                                  torch.zeros((), dtype=db_recv.dtype,
                                              device=db_recv.device))
            fresh = _scatter_recv(db_recv, send_idx, send_mask, max_inner)
            return fresh, ~_scatter_invalid_rows(inv, send_idx, max_inner)

        def ship_grad(ell, db, compute_dtype):
            """Encode one layer's (n, P, slot, pw) gradient send, exchange
            it (or queue it for the fused exchange), and return the
            owner-row contribution the backward consumes this step (stale
            buffer when pipelined). The decode dtype is the payload's own
            under the identity codec, the compute dtype after a lossy
            wire."""
            dtype = db.dtype if codecs[ell].name == "f32" else compute_dtype
            with spans.span("repro.exchange", device=True):
                wire = encode(ell, db, BWD)
                if fuse:
                    pending_grad.append((ell, wire, dtype))
                    return self._consume_buffer(buffers["grad"][ell])
                fresh, vrows = land_grad(ell, backend.exchange(wire), dtype)
                if pipe.stale:
                    new_grad[ell] = self._update_buffer_guarded(
                        buffers["grad"][ell], fresh, pipe.smooth_grad, vrows)
                    return self._consume_buffer(buffers["grad"][ell])
                new_grad[ell] = buffers["grad"][ell]
                return fresh

        j = dlogits
        for ell in reversed(range(L)):
            with spans.span(f"repro.step.bwd.L{ell}"):
                comb, z, u, dm = residuals[ell]
                fin, fout = dims[ell]
                w = params[f"w{ell}"]
                du = j if ell == L - 1 else j * (u > 0).to(j.dtype)
                grads[f"b{ell}"] = backend.psum(du.sum(dim=1))
                if ell in sliced:
                    # Sliced backward (transform-first, fout-wide exchange): ship
                    # the pre-w1 halo rows of dhw = Pᵀ·du to their owners and
                    # fold the owner contributions into the inner rows before
                    # the weight gradient and w1ᵀ; the scatter commutes with
                    # both, so vanilla mode equals the unsliced step.
                    w1 = w[:fin] if sage else w
                    h_in = comb      # residual slot 0: the masked inner rows
                    dhw = self.engine.spmm_t(tslice, du, combined)
                    db = dhw[:, max_inner:].reshape(n, P, topo.slot, fout)
                    dhw_eff = dhw[:, :max_inner] + ship_grad(ell, db, j.dtype)
                    gw = h_in.transpose(1, 2) @ dhw_eff
                    if sage:
                        gw = torch.cat([gw, h_in.transpose(1, 2) @ du], dim=1)
                    grads[f"w{ell}"] = backend.psum(gw)
                    j = dhw_eff @ w1.T
                    if sage:
                        j = j + du @ w[fin:].T
                    if dm is not None:
                        j = j * dm[:, :max_inner]
                    continue
                need_dcomb = ell > 0    # Alg. 1 stops the backward at layer 0
                gw, dh_local, db = self._layer_backward(
                    tslice, w, du, comb, z, dm, max_inner,
                    order=orders[ell], need_dcomb=need_dcomb)
                grads[f"w{ell}"] = backend.psum(gw)
                if ell == 0:
                    new_grad[0] = buffers["grad"][0]
                    break
                db = db.reshape(n, P, topo.slot, fin)
                j = dh_local + ship_grad(ell, db, j.dtype)

        if fuse and pending_grad:
            # ONE exchange for all L-1 boundary-gradient sends.
            with spans.span("repro.exchange", device=True):
                recvs = fused_exchange_encoded(
                    backend, [w_ for _, w_, _ in pending_grad])
            for (ell, _, dtype), recv in zip(pending_grad, recvs):
                with spans.span("repro.exchange", device=True):
                    fresh, vrows = land_grad(ell, recv, dtype)
                    new_grad[ell] = self._update_buffer_guarded(
                        buffers["grad"][ell], fresh, pipe.smooth_grad, vrows)

        new_buffers = {"feat": tuple(new_feat), "grad": tuple(new_grad)}
        if guard:
            # consecutive fallbacks per (direction, layer, peer): a valid
            # arrival resets to 0, a fallback adds 1; layer 0 ships no
            # backward gradient and counts as valid. Partition-local: no
            # exchange enters the step.
            ones = torch.ones_like(feat_pv[0])
            gv = [pv if pv is not None else ones for pv in grad_pv]
            ok = torch.stack([torch.stack(feat_pv, dim=-2),
                              torch.stack(gv, dim=-2)], dim=-3)
            new_buffers["es"] = torch.where(ok, 0, buffers["es"] + 1)
        return loss, logits, grads, new_buffers

    # ---------------- split-phase step ----------------

    def _step_impl_split(self, backend, topo: Topology, params, buffers,
                         data, generator, train: bool, sp: SplitSpec):
        """`_step_impl` under the split-phase overlap schedule.

        Each layer's aggregation is cut into a boundary phase (the output
        rows the next exchange reads: rows >= sp.row_tail forward, comb
        rows >= sp.col_tail transposed) and an interior phase. The
        boundary phase runs first, the payload is gathered from its rows,
        the exchange is started, the interior phase runs while it is in
        flight, and the exchange is waited on after the interior phase,
        before its first consumer: the next layer's input (vanilla), the
        backward's j (vanilla) or the t+1 buffer (stale). The fused
        schedule starts its one packed exchange per direction once the
        last payload is gathered and waits at the end of the pass. The
        exchange of layer 0's payload (x itself) is started before the
        loop; per layer it is waited on at once.

        Each phase is bit-identical to the unsplit kernel on its own rows
        and the dense algebra around it is row-local, so the split step
        equals the unsplit one; it only moves each exchange between the
        two phases (same count). The fused engine runs the composed phased
        path (the fused epilogue would push the unwritten out-of-phase rows
        through the weight), hence `layer_orders(..., fused=False)`.
        """
        L = self.model.num_layers
        dims = self.model.layer_dims()
        pipe = self.pipe
        P = topo.num_parts
        max_inner = topo.max_inner
        combined = max_inner + topo.halo_size
        n = topo.send_idx.shape[0]
        rt, ct = sp.row_tail, sp.col_tail
        sage = self.model.kind == "sage"
        engine = self.engine

        tslice = self._agg_slice(topo)
        send_idx, send_mask = topo.send_idx, topo.send_mask
        fuse = pipe.fused
        orders = self.layer_orders(topo, train=train, fused=False)
        # slicing never reaches the split (`_split_active`), but every wire
        # codec does: the split moves the exchange, the codec changes what
        # it carries
        codecs = self.wire_codecs(topo)
        pw = self.payload_widths(topo)
        dropout_rate = self.model.dropout if train else 0.0

        def spmm_phase(src, phase):
            backend.note(("spmm_phased", phase))
            return engine.spmm_phased(tslice, src, max_inner, sp, phase)

        def spmm_t_phase(src, phase):
            backend.note(("spmm_t_phased", phase))
            return engine.spmm_t_phased(tslice, src, combined, sp, phase)

        def land(ell, recv, dtype):
            fresh = codecs[ell].decode(recv, pw[ell], dtype)
            return fresh.reshape(n, P * topo.slot, pw[ell])

        residuals = []
        new_feat = [None] * L
        pending_feat = []
        feat_dtypes = []

        def finish_feat(ell, started):
            """Wait for layer ell's exchange; returns the halo it consumes
            (the fresh payload in vanilla mode, the stale state else)."""
            handle, dtype = started
            with spans.span("repro.exchange", device=True):
                fresh = land(ell, handle.wait(), dtype)
                if pipe.stale:
                    new_feat[ell] = self._update_buffer(
                        buffers["feat"][ell], fresh, pipe.smooth_feat)
                    return self._consume_buffer(buffers["feat"][ell])
                new_feat[ell] = buffers["feat"][ell]
                return fresh

        def send_feat(ell, payload):
            """Encode layer ell's payload and start its exchange, or under
            the fused schedule queue it and start the packed exchange once
            the last one is in. Returns (handle, the payload's dtype), None
            when fused, and, fused, the stale halo the layer consumes."""
            if not fuse:
                return (backend.start_exchange(codecs[ell].encode(payload)),
                        payload.dtype), None
            pending_feat.append(codecs[ell].encode(payload))
            feat_dtypes.append(payload.dtype)
            if ell == L - 1:
                flight["feat"] = start_fused_exchange_encoded(backend,
                                                              pending_feat)
            return None, self._consume_buffer(buffers["feat"][ell])

        flight = {}
        # -- forward -------------------------------------------------------
        h = data.x
        with spans.span("repro.exchange", device=True):
            started, halo = send_feat(
                0, _gather_send(h, send_idx, send_mask))
        if started is not None:
            halo = finish_feat(0, started)

        for ell in range(L):
            with spans.span(f"repro.step.fwd.L{ell}"):
                fin, _ = dims[ell]
                w, b = params[f"w{ell}"], params[f"b{ell}"]
                w1 = w[:fin] if sage else w
                dm = None
                if dropout_rate > 0.0:
                    dm = backend.dropout_mask(generator, dropout_rate,
                                              (n, combined, fin))
                comb = torch.cat([h, halo], dim=1)
                if dm is not None:
                    comb = comb * dm
                tf = orders[ell] == "transform-first"
                src = comb @ w1 if tf else comb
                act = ell < L - 1

                # boundary phase: rows [rt, max_inner) of raw_b are valid
                raw_b = spmm_phase(src, "boundary")
                tail_b = raw_b[:, rt:]
                u_bt = tail_b + b if tf else tail_b @ w1 + b
                if sage:
                    u_bt = u_bt + comb[:, rt:max_inner] @ w[fin:]
                h_bt = torch.relu(u_bt) if act else u_bt

                # the next layer's payload rows all lie in the tail just made:
                # start its exchange before the interior phase
                inflight = None
                if ell + 1 < L:
                    with spans.span("repro.exchange", device=True):
                        inflight, stale_halo = send_feat(
                            ell + 1, _gather_send_tail(h_bt, send_idx,
                                                       send_mask, rt))
                    if fuse:
                        halo = stale_halo

                # interior phase, while the exchange is in flight
                raw_i = spmm_phase(src, "interior")
                head_i = raw_i[:, :rt]
                if tf:
                    u_ih = head_i + b
                    z = None
                else:
                    u_ih = head_i @ w1 + b
                    z = torch.cat([head_i, tail_b], dim=1) if train else None
                if sage:
                    u_ih = u_ih + comb[:, :rt] @ w[fin:]
                if inflight is not None:
                    halo = finish_feat(ell + 1, inflight)
                u = torch.cat([u_ih, u_bt], dim=1)
                residuals.append((comb, z, u, dm))
                h = torch.cat([torch.relu(u_ih), h_bt], dim=1) if act else u

        if fuse:
            with spans.span("repro.exchange", device=True):
                recvs = flight.pop("feat").wait()
            for ell, recv in enumerate(recvs):
                with spans.span("repro.exchange", device=True):
                    new_feat[ell] = self._update_buffer(
                        buffers["feat"][ell],
                        land(ell, recv, feat_dtypes[ell]), pipe.smooth_feat)

        logits = h
        with spans.span("repro.step.loss"):
            loss, dlogits = self._loss(backend, logits, data)
        if not train:
            return loss, logits, None, None

        # -- manual backward ----------------------------------------------
        # The transposed mirror of the forward: the boundary phase of Pᵀ·δ
        # produces comb rows >= ct, a superset of the halo rows that form
        # the gradient send, so the exchange is started between the two
        # transpose phases (fused: at the last backward layer, ell == 1).
        grads = {}
        new_grad = [None] * L
        pending_grad = []        # fused mode: (ell, wire, dtype)

        def land_grad(ell, recv, dtype):
            return _scatter_recv(codecs[ell].decode(recv, pw[ell], dtype),
                                 send_idx, send_mask, max_inner)

        j = dlogits
        for ell in reversed(range(L)):
            with spans.span(f"repro.step.bwd.L{ell}"):
                comb, z, u, dm = residuals[ell]
                fin, _ = dims[ell]
                w = params[f"w{ell}"]
                w1 = w[:fin] if sage else w
                du = j if ell == L - 1 else j * (u > 0).to(j.dtype)
                grads[f"b{ell}"] = backend.psum(du.sum(dim=1))
                if ell == 0:
                    # Alg. 1 stops the backward at layer 0: weight gradient
                    # only, through the unsplit per-layer backward
                    gw, _, _ = self._layer_backward(
                        tslice, w, du, comb, z, dm, max_inner, order=orders[0],
                        need_dcomb=False)
                    grads["w0"] = backend.psum(gw)
                    new_grad[0] = buffers["grad"][0]
                    break

                tf = orders[ell] == "transform-first"
                # one dense op ahead of both phases under aggregate-first
                # (δhw = du·w1ᵀ); transform-first transposes du itself and
                # applies w1ᵀ per phase (the pre-w1 pieces feed the weight grad)
                src_t = du if tf else du @ w1.T
                if sage:
                    sage_t = du @ w[fin:].T

                # boundary phase: comb rows [ct, combined) valid
                raw_tb = spmm_t_phase(src_t, "boundary")
                dhw_b = raw_tb[:, ct:]
                d_bt = dhw_b @ w1.T if tf else dhw_b
                if sage:
                    d_bt = torch.cat([d_bt[:, :max_inner - ct]
                                      + sage_t[:, ct:],
                                      d_bt[:, max_inner - ct:]], dim=1)
                if dm is not None:
                    d_bt = d_bt * dm[:, ct:]

                # the gradient send is the halo rows of the boundary phase,
                # decoded in the payload's dtype under the identity codec and
                # in the compute dtype after a lossy wire
                db = d_bt[:, max_inner - ct:].reshape(n, P, topo.slot, fin)
                db_dtype = db.dtype if codecs[ell].name == "f32" else j.dtype
                inflight = None
                with spans.span("repro.exchange", device=True):
                    wire = codecs[ell].encode(db)
                    if fuse:
                        pending_grad.append((ell, wire, db_dtype))
                        contrib = self._consume_buffer(buffers["grad"][ell])
                        if ell == 1:
                            flight["grad"] = start_fused_exchange_encoded(
                                backend, [w_ for _, w_, _ in pending_grad])
                    else:
                        inflight = backend.start_exchange(wire)

                # interior phase, while the exchange is in flight
                raw_ti = spmm_t_phase(src_t, "interior")
                dhw_i = raw_ti[:, :ct]
                if tf:
                    d_ih = dhw_i @ w1.T
                    dhw_full = torch.cat([dhw_i, dhw_b], dim=1)
                    gw = comb.transpose(1, 2) @ dhw_full
                else:
                    d_ih = dhw_i
                    gw = z.transpose(1, 2) @ du
                if sage:
                    gw = torch.cat(
                        [gw, comb[:, :max_inner].transpose(1, 2) @ du], dim=1)
                    d_ih = d_ih + sage_t[:, :ct]
                if dm is not None:
                    d_ih = d_ih * dm[:, :ct]
                grads[f"w{ell}"] = backend.psum(gw)
                if inflight is not None:
                    with spans.span("repro.exchange", device=True):
                        fresh = land_grad(ell, inflight.wait(), db_dtype)
                        if pipe.stale:
                            contrib = self._consume_buffer(
                                buffers["grad"][ell])
                            new_grad[ell] = self._update_buffer(
                                buffers["grad"][ell], fresh, pipe.smooth_grad)
                        else:
                            contrib = fresh
                            new_grad[ell] = buffers["grad"][ell]
                j = torch.cat([d_ih, d_bt[:, :max_inner - ct]], dim=1) + contrib

        if fuse and pending_grad:
            with spans.span("repro.exchange", device=True):
                recvs = flight.pop("grad").wait()
            for (ell, _, dtype), recv in zip(pending_grad, recvs):
                with spans.span("repro.exchange", device=True):
                    new_grad[ell] = self._update_buffer(
                        buffers["grad"][ell], land_grad(ell, recv, dtype),
                        pipe.smooth_grad)

        return loss, logits, grads, {"feat": tuple(new_feat),
                                     "grad": tuple(new_grad)}

    # ---------------- public API ----------------

    def train_step(self, topo: Topology, params, buffers, data: ShardedData,
                   generator: torch.Generator | None = None, backend=None,
                   step_idx: int | None = None, faults=None):
        """Training step over the backend's partitions (default the sim
        backend: all P). Returns (loss, grads, new_buffers, logits);
        grads are summed over all partitions. `generator` draws the
        dropout masks (one per layer); it may be None at dropout 0.
        `faults` (compiled FaultTables) and `step_idx` inject that step's
        exchange faults."""
        if self.model.dropout > 0.0 and generator is None:
            raise ValueError("dropout > 0 needs a torch.Generator")
        if faults is not None and step_idx is None:
            raise ValueError("faults need the step index (step_idx)")
        exact_f32_matmul()
        with torch.no_grad():
            loss, logits, grads, new_buffers = self._step_impl(
                SimBackend() if backend is None else backend, topo, params,
                buffers, data, generator, train=True, step_idx=step_idx,
                faults=faults)
        return loss, grads, new_buffers, logits

    def forward(self, topo: Topology, params, data: ShardedData,
                backend=None):
        """Inference forward with synchronous (fresh) exchange — used for
        evaluation, like the paper's test-time behaviour. Keeps the split
        spec: under a vanilla PipeConfig ("auto" overlap) a tile engine
        evaluates through the split-phase step, as in the JAX package."""
        fresh_self = dataclasses.replace(self, pipe=PipeConfig.vanilla())
        buffers = fresh_self.init_buffers(topo, dtype=data.x.dtype)
        exact_f32_matmul()
        with torch.no_grad():
            loss, logits, _, _ = fresh_self._step_impl(
                SimBackend() if backend is None else backend, topo, params,
                buffers, data, None, train=False)
        return loss, logits
