"""PipeGCN core: partition-parallel full-graph GCN training with pipelined
(one-iteration-deferred) boundary feature / feature-gradient communication,
per the paper's Alg. 1 and Eq. 3–4, plus the §3.4 EMA smoothing.

Port of the JAX package's ``repro.core.pipegcn`` on the single-device sim
backend: partitions are a leading tensor axis, and the boundary exchange is
a transpose of the (sender, receiver) axes. The backward pass is written by
hand as in Alg. 1 (a stale gradient produced at step t is applied at t+1,
which autograd cannot express), so no tensor here requires grad.

Where the JAX package vmaps a per-partition function over the partition
axis, this module writes the partition axis out as a batch dimension:
every tensor of the step carries it, gathers and scatters index a
flattened partition×row axis, and one kernel launch covers all partitions.

This slice runs the unsplit, fault-free, identity-wire step: variants
vanilla / pipegcn / -g / -f / -gf, k-step FIFOs (``staleness_steps``) and
the fused deferred exchange, with the "coo", "blocksparse" and "fused"
engines.
The options it does not run raise ``NotImplementedError`` when a
``PipeGCN`` is built, naming the ROADMAP item that ports them.

State layout (per layer ℓ; widths follow the layer inputs):
  feat_buf[ℓ] : (P, P*slot, F_ℓ)   stale boundary features   (Eq. 3 h^(t-1))
  grad_buf[ℓ] : (P, max_inner, F_ℓ) stale boundary-gradient contributions,
                already exchanged and scattered to owner rows (Eq. 4 δ^(t-1))
With ``staleness_steps`` k > 1 each buffer gains a leading FIFO axis of k.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.config import ModelConfig, PipeConfig
from repro_torch.graph.halo import PartitionedGraph, extract_partition_tiles
from repro_torch.graph.reorder import TILE_ENGINES
from repro_torch.kernels.aggregate import get_engine
from repro_torch.kernels.gcn_spmm import TILE, live_lengths, run_pointers


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; asking
    for CUDA without one raises — the port never drops to the CPU unless
    the caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the port on the CPU")
    return dev


def exact_f32_matmul():
    """Keep the dense products in full float32 on the card (no TF32): the
    JAX package computes them in f32 and the kernels use f32 FMA."""
    torch.backends.cuda.matmul.allow_tf32 = False


class Topology(NamedTuple):
    """Device-ready padded partition topology (leading axis = partition).

    The COO fields are always present; the `tile_*` fields (block-sparse
    streams, see repro_torch.kernels.gcn_spmm) are attached by
    ``topology_from(pg, with_tiles=True)`` and stay None otherwise. The run
    pointers ``tile_row_ptr`` / ``tile_col_ptr`` index the row-sorted
    forward stream and the column-sorted transpose stream per output block;
    ``tile_live`` / ``tile_t_live`` are the streams' live lengths (past
    them only zero padding tiles remain).
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
    tile_live: torch.Tensor | None = None     # (P,) int32
    tile_t_live: torch.Tensor | None = None   # (P,) int32

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
    their live lengths."""
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
                     tile_live=t(live_lengths(pt.vals)),
                     tile_t_live=t(live_lengths(pt.vals, pt.t_perm)))
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


# ----------------------------------------------------------------------
# Boundary gather / scatter over the partition axis
# ----------------------------------------------------------------------

def _gather_send(h, send_idx, send_mask):
    """(P, max_inner, F) -> (P, P, slot, F): row send_idx[p, j, k] of
    partition p, the payload partition p sends to peer j (0 where masked)."""
    p, peers, slot = send_idx.shape
    rows = torch.arange(p, device=h.device)[:, None]
    out = h[rows, send_idx.reshape(p, -1).long()]
    out = out.reshape(p, peers, slot, h.shape[-1])
    return torch.where(send_mask[..., None], out, 0.0)


def _scatter_recv(contrib, send_idx, send_mask, max_inner: int):
    """(P, P, slot, F) received gradient blocks -> (P, max_inner, F):
    partition p adds recv[p, j, k] into its row send_idx[p, j, k]."""
    p, peers, slot, f = contrib.shape
    contrib = torch.where(send_mask[..., None], contrib, 0.0)
    flat = (send_idx.reshape(p, -1).long()
            + max_inner * torch.arange(p, device=contrib.device)[:, None])
    out = contrib.new_zeros(p * max_inner, f)
    out.index_add_(0, flat.reshape(-1), contrib.reshape(p * peers * slot, f))
    return out.reshape(p, max_inner, f)


# ----------------------------------------------------------------------
# Fused deferred exchange: per-layer payloads packed along the feature
# axis and exchanged once (the exchange is pure data movement, so packing
# commutes with it exactly).
# ----------------------------------------------------------------------

def pack_payloads(payloads):
    """Per-layer (P, P, slot, F_l) sends -> one (P, P, slot, ΣF_l)."""
    return torch.cat(payloads, dim=-1)


def unpack_payloads(packed, widths):
    """Inverse of `pack_payloads` given the per-layer width table."""
    return list(torch.split(packed, list(widths), dim=-1))


class SimBackend:
    """Partitions as the leading axis on a single device: the exchanges
    are transposes, and the reductions over partitions (weight gradients,
    loss) are plain sums over the leading axis."""

    def exchange(self, s):
        # s: (P_sender, P_receiver, slot, F); R[i, j] = S[j, i]
        return s.transpose(0, 1)

    def fused_exchange(self, payloads):
        """[self.exchange(p) for p in payloads], in one exchange."""
        recv = self.exchange(pack_payloads(payloads))
        return unpack_payloads(recv, [int(p.shape[-1]) for p in payloads])

    def dropout_mask(self, generator, rate, shape):
        keep = torch.rand(shape, generator=generator,
                          device=generator.device) >= rate
        return keep.to(torch.float32) / (1.0 - rate)


# ----------------------------------------------------------------------
# Losses (masked, globally normalized)
# ----------------------------------------------------------------------

def _ce_loss_and_grad(logits, labels, mask, total):
    """Masked softmax cross-entropy; returns (sum, dlogits)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss_sum = torch.sum((lse - ll) * mask)
    probs = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(
        labels.long(), logits.shape[-1]).to(logits.dtype)
    dlogits = (probs - onehot) * mask[..., None] / total
    return loss_sum, dlogits


def _bce_loss_and_grad(logits, labels, mask, total):
    """Masked multi-label sigmoid BCE (Yelp-style); total counts node·class."""
    z, y = logits, labels.to(logits.dtype)
    per = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    loss_sum = torch.sum(per * mask[..., None])
    dlogits = (torch.sigmoid(z) - y) * mask[..., None] / total
    return loss_sum, dlogits


# ----------------------------------------------------------------------
# The module
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PipeGCN:
    """Partition-parallel GCN with pipelined communication.

    Parameters, pipeline buffers and the dropout generator are explicit
    arguments, as in the JAX package, so a step is a function of its
    inputs. The step always runs unsplit: the split-phase schedule is not
    ported, which is what the JAX package does without a SplitSpec.
    """

    model: ModelConfig
    pipe: PipeConfig

    def __post_init__(self):
        get_engine(self.model.agg)      # unknown or unported engines raise
        unported = []
        if self.pipe.wire != "f32":
            unported.append(f"wire={self.pipe.wire!r} (ROADMAP Queue 1 "
                            "item 8: boundary codecs)")
        if self.pipe.slice_boundary:
            unported.append("slice_boundary (ROADMAP Queue 1 item 8)")
        if self.pipe.guard_exchange:
            unported.append("guard_exchange (ROADMAP Queue 1 item 9: "
                            "fault tolerance)")
        if self.pipe.overlap == "split-phase":
            unported.append("overlap='split-phase' (ROADMAP Queue 1 item 6)")
        if unported:
            raise NotImplementedError(
                "not ported to repro_torch yet: " + "; ".join(unported))

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
        0). With staleness_steps k > 1 each buffer is a FIFO along a new
        leading axis of size k (slot 0 = oldest = consumed)."""
        p = topo.num_parts
        k = self.pipe.staleness_steps
        lead = ((k,) if k > 1 else ()) + (p,)
        dev = topo.send_idx.device
        feat, grad = [], []
        for w in self.payload_widths(topo):
            feat.append(torch.zeros(lead + (topo.halo_size, w), dtype=dtype,
                                    device=dev))
            grad.append(torch.zeros(lead + (topo.max_inner, w), dtype=dtype,
                                    device=dev))
        return {"feat": tuple(feat), "grad": tuple(grad)}

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

    def payload_widths(self, topo: Topology) -> tuple[int, ...]:
        """Per-layer feature width of the boundary exchange payload (the
        layer input width fin; sliced layers are not ported)."""
        return tuple(fin for fin, _ in self.model.layer_dims())

    def layer_orders(self, topo: Topology, train: bool = True) -> tuple[str, ...]:
        """Per-layer matmul ordering the step runs with: forced, or "auto"
        through the static FLOP model fed the shard's effective sparse work
        (n_tiles·T² for the tile engines, the padded COO length otherwise)
        and priced for the fused kernels when the engine is "fused" — the
        JAX package's `_base_orders` inputs on its unsplit schedule, so
        both resolve to the same orders (there are no sliced layers to
        override it here)."""
        mo = self.model.matmul_order
        L = self.model.num_layers
        if mo != "auto":
            return (mo,) * L
        combined = topo.max_inner + topo.halo_size
        if self.engine.name in TILE_ENGINES and topo.tile_rows is not None:
            nnz_eff = [topo.tile_rows.shape[-1] * TILE * TILE] * L
        else:
            nnz_eff = [topo.edge_row.shape[-1]] * L
        from repro_torch.analysis.cost import choose_gcn_orders
        return choose_gcn_orders(self.model.layer_dims(), topo.max_inner,
                                 combined, nnz_eff, train=train,
                                 fused=self.engine.name == "fused",
                                 tile=TILE)

    def _layer_forward(self, tslice, w, b, h_prev, halo, drop_mask,
                       order: str = "aggregate-first",
                       fuse_relu: bool = False, with_z: bool = True):
        """One GCN/SAGE layer over all partitions. Returns (u, (comb, z)):
        comb (P, combined, fin) is the [inner; halo] input after dropout, z
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
        """Manual VJP of one layer over all partitions. Returns (gW summed
        over partitions, dH_inner_local, dB_halo); the d-terms are None
        when `need_dcomb=False` (layer 0 — Alg. 1 stops the backward there,
        though transform-first still needs Pᵀ·du for its weight gradient).
        """
        combined = comb.shape[1]
        fin = comb.shape[-1]
        sage = self.model.kind == "sage"
        w1 = w[:fin] if sage else w
        inner_t = comb[:, :max_inner].transpose(1, 2)
        if order == "transform-first":
            dhw = self.engine.spmm_t(tslice, du, combined)
            gw = (comb.transpose(1, 2) @ dhw).sum(0)   # = Σ zᵀ·du without z
            if sage:
                gw = torch.cat([gw, (inner_t @ du).sum(0)], dim=0)
            if not need_dcomb:
                return gw, None, None
            dcomb = dhw @ w1.T
        else:
            gw = (z.transpose(1, 2) @ du).sum(0)
            if sage:
                gw = torch.cat([gw, (inner_t @ du).sum(0)], dim=0)
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

    # ---------------- forward/backward step ----------------

    def _step_impl(self, backend, topo: Topology, params, buffers, data,
                   generator, train: bool):
        """One step over all partitions. Returns (loss, logits, grads,
        new_buffers); grads and new_buffers are None when `train=False`."""
        L = self.model.num_layers
        dims = self.model.layer_dims()
        pipe = self.pipe
        P = topo.num_parts
        max_inner = topo.max_inner
        combined = max_inner + topo.halo_size

        tslice = self._agg_slice(topo)
        send_idx, send_mask = topo.send_idx, topo.send_mask
        fuse = pipe.fused        # stale + fuse_exchange: deferred exchanges
        orders = self.layer_orders(topo, train=train)
        pw = self.payload_widths(topo)
        dropout_rate = self.model.dropout if train else 0.0

        h = data.x
        residuals = []
        new_feat = [None] * L
        pending_feat = []        # fused mode: per-layer sends, exchanged once

        def land(recv, ell):
            """(P, P, slot, pw) received payload -> (P, P·slot, pw) halo."""
            return recv.reshape(P, P * topo.slot, pw[ell])

        for ell in range(L):
            fin, _ = dims[ell]
            dm = None
            if dropout_rate > 0.0:
                dm = backend.dropout_mask(generator, dropout_rate,
                                          (P, combined, fin))
            act = ell < L - 1
            fuse_relu = act and not train
            payload = _gather_send(h, send_idx, send_mask)
            if fuse:
                # Stale mode: the exchange result is consumed only at t+1,
                # so defer the send into the packed exchange and read this
                # step's halo straight from the pipeline state.
                pending_feat.append(payload)
                halo = self._consume_buffer(buffers["feat"][ell])
            else:
                fresh = land(backend.exchange(payload), ell)
                if pipe.stale:
                    halo = self._consume_buffer(buffers["feat"][ell])
                    new_feat[ell] = self._update_buffer(
                        buffers["feat"][ell], fresh, pipe.smooth_feat)
                else:
                    halo = fresh
                    new_feat[ell] = buffers["feat"][ell]
            u, (comb, z) = self._layer_forward(
                tslice, params[f"w{ell}"], params[f"b{ell}"], h, halo, dm,
                order=orders[ell], fuse_relu=fuse_relu, with_z=train)
            residuals.append((comb, z, u, dm))
            h = torch.relu(u) if act and not fuse_relu else u

        if fuse:
            # ONE exchange for all L layers' boundary features; the results
            # land in the t+1 buffers.
            for ell, recv in enumerate(backend.fused_exchange(pending_feat)):
                new_feat[ell] = self._update_buffer(
                    buffers["feat"][ell], land(recv, ell), pipe.smooth_feat)

        logits = h

        # -- loss ---------------------------------------------------------
        mask = data.train_mask.to(logits.dtype)
        count = torch.sum(mask)
        if self.model.multilabel:
            count = count * self.model.num_classes
        total = torch.clamp(count, min=1.0)
        loss_fn = (_bce_loss_and_grad if self.model.multilabel
                   else _ce_loss_and_grad)
        loss_sum, dlogits = loss_fn(logits, data.labels, mask, total)
        loss = loss_sum / total

        if not train:
            return loss, logits, None, None

        # -- manual backward (Alg. 1 lines 17–30) --------------------------
        grads = {}
        new_grad = [None] * L
        pending_grad = []        # fused mode: (ell, send), exchanged once

        def ship_grad(ell, db):
            """Exchange one layer's (P, P, slot, fin) gradient send (or queue
            it for the fused exchange) and return the owner-row contribution
            the backward consumes this step (stale buffer when pipelined)."""
            if fuse:
                pending_grad.append((ell, db))
                return self._consume_buffer(buffers["grad"][ell])
            fresh = _scatter_recv(backend.exchange(db), send_idx, send_mask,
                                  max_inner)
            if pipe.stale:
                contrib = self._consume_buffer(buffers["grad"][ell])
                new_grad[ell] = self._update_buffer(
                    buffers["grad"][ell], fresh, pipe.smooth_grad)
                return contrib
            new_grad[ell] = buffers["grad"][ell]
            return fresh

        j = dlogits
        for ell in reversed(range(L)):
            comb, z, u, dm = residuals[ell]
            du = j if ell == L - 1 else j * (u > 0).to(j.dtype)
            grads[f"b{ell}"] = du.sum(dim=(0, 1))
            need_dcomb = ell > 0    # Alg. 1 stops the backward at layer 0
            gw, dh_local, db = self._layer_backward(
                tslice, params[f"w{ell}"], du, comb, z, dm, max_inner,
                order=orders[ell], need_dcomb=need_dcomb)
            grads[f"w{ell}"] = gw
            if ell == 0:
                new_grad[0] = buffers["grad"][0]
                break
            db = db.reshape(P, P, topo.slot, dims[ell][0])
            j = dh_local + ship_grad(ell, db)

        if fuse and pending_grad:
            # ONE exchange for all L-1 boundary-gradient sends.
            recvs = backend.fused_exchange([d for _, d in pending_grad])
            for (ell, _), recv in zip(pending_grad, recvs):
                fresh = _scatter_recv(recv, send_idx, send_mask, max_inner)
                new_grad[ell] = self._update_buffer(
                    buffers["grad"][ell], fresh, pipe.smooth_grad)

        return loss, logits, grads, {"feat": tuple(new_feat),
                                     "grad": tuple(new_grad)}

    # ---------------- public API ----------------

    def train_step(self, topo: Topology, params, buffers, data: ShardedData,
                   generator: torch.Generator | None = None):
        """Sim-backend training step over (P, ...) tensors. Returns
        (loss, grads, new_buffers, logits). `generator` draws the dropout
        masks (one per layer); it may be None at dropout 0."""
        if self.model.dropout > 0.0 and generator is None:
            raise ValueError("dropout > 0 needs a torch.Generator")
        exact_f32_matmul()
        with torch.no_grad():
            loss, logits, grads, new_buffers = self._step_impl(
                SimBackend(), topo, params, buffers, data, generator,
                train=True)
        return loss, grads, new_buffers, logits

    def forward(self, topo: Topology, params, data: ShardedData):
        """Inference forward with synchronous (fresh) exchange — used for
        evaluation, like the paper's test-time behaviour."""
        fresh_self = dataclasses.replace(self, pipe=PipeConfig.vanilla())
        buffers = fresh_self.init_buffers(topo, dtype=data.x.dtype)
        exact_f32_matmul()
        with torch.no_grad():
            loss, logits, _, _ = fresh_self._step_impl(
                SimBackend(), topo, params, buffers, data, None, train=False)
        return loss, logits
