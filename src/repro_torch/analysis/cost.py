"""Analytic FLOP / HBM-byte models: the LM zoo's architectures
(`analytic_cost`), the PipeGCN layer matmul ordering (aggregate-first vs
transform-first) and the graph-layout report.

Port copy of the JAX package's ``repro.analysis.cost``. The "auto" matmul
order resolves through ``choose_gcn_orders`` exactly as in the JAX
package. The LM model is exact for the matmul-dominated terms and an
explicit approximation elsewhere; all its counts are GLOBAL per step
(divide by chip count for per-device terms). JAX counts the parameters
with ``jax.eval_shape``; the port draws them on the ``meta`` device
(`param_count`), which allocates nothing.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.models.model import LM, decoder_layer_specs


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: the init
    functions draw on their generator's device, so `LM.init_params` given
    one builds every leaf's shape and dtype without storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


class _MetaDraws(TorchDispatchMode):
    """Answers a draw on the ``meta`` device (``torch.randn`` with a
    generator) with an empty tensor of its shape and dtype, without the
    reference decomposition that a meta draw otherwise runs op by op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.randn.generator:
            return torch.empty(args[0], dtype=kwargs.get("dtype"),
                               device="meta")
        return func(*args, **kwargs)


@functools.lru_cache(maxsize=None)
def meta_param_tree(cfg: ArchConfig) -> dict:
    """`LM(cfg).init_params`'s tree with every leaf on the ``meta`` device
    (no memory, any model size), drawn once per config: callers only read
    it."""
    with _MetaDraws():
        return LM(cfg).init_params(_MetaGenerator())


def param_count(cfg: ArchConfig) -> int:
    """The number of parameters `LM(cfg).init_params` draws."""
    return sum(x.numel() for x in tree_leaves(meta_param_tree(cfg)))


def _attn_flops_per_tok(cfg: ArchConfig, kv_len: float, causal: bool) -> float:
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    d = cfg.d_model
    proj = 2 * d * (2 * h * hd + 2 * k * hd)          # q,o + k,v
    eff = kv_len / 2 if causal and cfg.sliding_window == 0 else \
        min(kv_len, cfg.sliding_window) if cfg.sliding_window else kv_len
    scores = 2 * eff * h * hd * 2                      # QK^T and PV
    return proj + scores


def _mla_flops_per_tok(cfg: ArchConfig, kv_len: float) -> float:
    h = cfg.num_heads
    d = cfg.d_model
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    r = cfg.kv_lora_rank
    if cfg.q_lora_rank:
        q = 2 * d * cfg.q_lora_rank + 2 * cfg.q_lora_rank * h * qk
    else:
        q = 2 * d * h * qk
    kv = 2 * d * r + 2 * d * cfg.qk_rope_dim \
        + 2 * r * h * cfg.qk_nope_dim + 2 * r * h * cfg.v_head_dim
    eff = min(kv_len, cfg.sliding_window) if cfg.sliding_window else kv_len / 2
    scores = 2 * eff * h * (qk + cfg.v_head_dim)
    out = 2 * h * cfg.v_head_dim * d
    return q + kv + scores + out


def _mlp_flops_per_tok(cfg: ArchConfig) -> float:
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    return 2.0 * cfg.d_model * cfg.d_ff * mult


def _moe_flops_per_tok(cfg: ArchConfig, dropless: bool) -> float:
    d, f = cfg.d_model, cfg.moe_d_ff
    router = 2.0 * d * cfg.num_experts
    factor = 1.0 if dropless else cfg.capacity_factor
    routed = 2.0 * d * f * 3 * cfg.experts_per_tok * factor
    shared = 2.0 * d * f * cfg.num_shared_experts * 3
    return router + routed + shared


def _ssd_flops_per_tok(cfg: ArchConfig, decode: bool) -> float:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, hp = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    proj = 2.0 * d * (2 * di + 2 * g * n + h) + 2.0 * di * d
    conv = 2.0 * cfg.ssm_conv * (di + 2 * g * n)
    if decode:
        scan = 2.0 * h * hp * n * 2                      # state update + out
    else:
        q = cfg.ssm_chunk
        # intra-chunk dual form + chunk states + inter-chunk contribution
        scan = 2.0 * q * h * (n + hp) + 4.0 * h * hp * n
    return proj + conv + scan


def _rglru_flops_per_tok(cfg: ArchConfig) -> float:
    d = cfg.d_model
    w = cfg.lru_width or d
    return 2.0 * d * w * 2 + 2.0 * w * w * 2 + 2.0 * w * d \
        + 2.0 * cfg.conv1d_width * w


def _xattn_flops_per_tok(cfg: ArchConfig, mem_len: float,
                         cached: bool) -> float:
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    d = cfg.d_model
    proj = 2 * d * 2 * h * hd                          # q,o every call
    kv = 0.0 if cached else 2 * d * 2 * k * hd * 1.0   # amortized at prefill
    scores = 2 * mem_len * h * hd * 2
    return proj + kv + scores


def analytic_cost(cfg: ArchConfig, shape: InputShape) -> dict:
    """Global FLOPs and HBM bytes for one step of the given mode."""
    specs = decoder_layer_specs(cfg)
    mem_len = cfg.num_audio_frames if cfg.is_encdec else cfg.num_image_tokens
    b, s = shape.global_batch, shape.seq_len
    decode = shape.mode == "decode"
    toks = b * (1 if decode else s)
    kv_len = s if not decode else s                     # cache length
    if decode and cfg.sliding_window:
        kv_len = min(s, cfg.sliding_window)

    per_tok = 0.0
    for spec in specs:
        if spec.mixer == "attn":
            per_tok += _attn_flops_per_tok(cfg, kv_len, causal=True)
        elif spec.mixer == "mla":
            per_tok += _mla_flops_per_tok(cfg, kv_len)
        elif spec.mixer == "ssd":
            per_tok += _ssd_flops_per_tok(cfg, decode)
        elif spec.mixer == "rglru":
            per_tok += _rglru_flops_per_tok(cfg)
        elif spec.mixer == "xattn":
            per_tok += _xattn_flops_per_tok(cfg, mem_len, cached=decode)
        if spec.cross:
            per_tok += _xattn_flops_per_tok(cfg, mem_len, cached=decode)
        if spec.ffn == "dense":
            per_tok += _mlp_flops_per_tok(cfg)
        elif spec.ffn == "moe":
            per_tok += _moe_flops_per_tok(cfg, dropless=decode)
    per_tok += 2.0 * cfg.d_model * cfg.padded_vocab     # logits

    fwd = per_tok * toks
    if cfg.is_encdec and not decode:
        enc_tok = b * cfg.num_audio_frames
        enc_per_tok = (_attn_flops_per_tok(cfg, cfg.num_audio_frames, False)
                       + _mlp_flops_per_tok(cfg))
        fwd += enc_per_tok * enc_tok * cfg.encoder_layers

    p_total = param_count(cfg)

    if shape.mode == "train":
        flops = 4.0 * fwd            # fwd + bwd(2x) + remat re-fwd(1x)
        # params: read fwd + read bwd + remat (bf16) ; grads write (bf16);
        # adam state read+write (f32 m,v) + param update
        bytes_params = p_total * (3 * 2 + 2 + 4 * 4 + 2 * 2)
        act_bytes = toks * cfg.d_model * 2 * len(specs) * 6
        bytes_total = bytes_params + act_bytes \
            + toks * cfg.padded_vocab * 2 * 2
    else:
        flops = fwd
        bytes_params = p_total * 2                     # one read, bf16
        if decode:
            cache_bytes = _cache_bytes(cfg, b, kv_len)
            bytes_total = bytes_params + cache_bytes * 2   # read + write
            act_bytes = toks * cfg.d_model * 2 * len(specs) * 4
            bytes_total += act_bytes
        else:
            act_bytes = toks * cfg.d_model * 2 * len(specs) * 6
            bytes_total = bytes_params + act_bytes \
                + _cache_bytes(cfg, b, min(s, kv_len))
    return {"flops_global": float(flops), "hbm_bytes_global": float(bytes_total),
            "params_total": p_total}


def _cache_bytes(cfg: ArchConfig, batch: int, length: int) -> float:
    specs = decoder_layer_specs(cfg)
    total = 0.0
    for spec in specs:
        if spec.mixer == "attn":
            total += 2 * batch * length * cfg.num_kv_heads \
                * cfg.resolved_head_dim * 2
        elif spec.mixer == "mla":
            total += batch * length * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
        elif spec.mixer == "ssd":
            total += batch * cfg.ssm_nheads * cfg.ssm_headdim \
                * cfg.ssm_state * 4
        elif spec.mixer == "rglru":
            total += batch * (cfg.lru_width or cfg.d_model) * 4
        if spec.cross or spec.mixer == "xattn":
            mem = cfg.num_audio_frames if cfg.is_encdec else cfg.num_image_tokens
            total += 2 * batch * mem * cfg.num_kv_heads \
                * cfg.resolved_head_dim * 2
    return total



GCN_ORDERS = ("aggregate-first", "transform-first")
_TILE = 128       # adjacency tile edge (repro_torch.kernels.gcn_spmm.TILE)


@dataclasses.dataclass(frozen=True)
class GcnLayerCost:
    """FLOPs + approximate HBM traffic of one layer under one ordering."""

    flops: float
    hbm_bytes: float


def gcn_layer_order_cost(order: str, fin: int, fout: int, num_rows: int,
                         combined: int, nnz_eff: float,
                         first_layer: bool = False, train: bool = True,
                         fused: bool = False, tile: int = _TILE,
                         dtype_bytes: int = 4) -> GcnLayerCost:
    """Cost of one GCN layer (fwd + manual bwd) under `order`.

    num_rows: inner (output) rows n; combined: [inner; halo] rows c of the
    aggregation input; nnz_eff: effective sparse multiply-adds per feature
    column. `first_layer`: Alg. 1 stops the backward at layer 0 —
    aggregate-first then skips its backward SpMM entirely, while
    transform-first still needs Pᵀ·du for the weight gradient
    (gw = combᵀ·(Pᵀ·du)). `fused` (aggregate-first only): the fused kernels
    skip the HBM round-trips of the (rows, F_in) intermediates (z re-read
    fwd; dz write+read bwd) but the backward prologue recomputes du@wᵀ once
    per TILE-row tile slot instead of once per row block — e/tile
    transformed rows instead of n.
    """
    if order not in GCN_ORDERS:
        raise ValueError(f"unknown order {order!r}; have {GCN_ORDERS}")
    n, c, e = float(num_rows), float(combined), float(nnz_eff)
    spmm_in, spmm_out = 2.0 * e * fin, 2.0 * e * fout
    if order == "aggregate-first":
        # fwd: z = P·comb (spmm_in), u = z@w.
        # bwd: gw = zᵀ·du; dz = du@wᵀ; dcomb = Pᵀ·dz (spmm_in).
        flops = spmm_in + 2.0 * n * fin * fout
        bytes_ = (c * fin                          # read comb
                  + e                              # tile/edge values
                  + n * fin                        # write z (residual)
                  + (0.0 if fused else n * fin)    # re-read z for the matmul
                  + fin * fout + n * fout)         # weight + write u
        if train:
            flops += 2.0 * n * fin * fout          # gw
            bytes_ += n * fout + n * fin + fin * fout      # du, z, gw
            if not first_layer:
                # dz rows: per row block once (unfused) vs per tile slot
                # (fused prologue recompute, e/tile rows total)
                dz_rows = (e / tile) if fused else n
                flops += 2.0 * dz_rows * fin * fout + spmm_in
                bytes_ += (fin * fout                          # w for dz
                           + (0.0 if fused else 2.0 * n * fin)  # dz rt
                           + e + c * fin)                      # tiles+dcomb
        return GcnLayerCost(flops=flops, hbm_bytes=bytes_ * dtype_bytes)
    # transform-first (always composed: dense matmul + SpMM over F_out)
    # fwd: hw = comb@w, u = P·hw.
    # bwd: dhw = Pᵀ·du (always — gw = combᵀ·dhw needs it); dcomb = dhw@wᵀ.
    flops = 2.0 * c * fin * fout + spmm_out
    bytes_ = (c * fin + fin * fout             # read comb + w
              + 2.0 * c * fout                 # hw write + read
              + e + n * fout)                  # tiles + write u
    if train:
        flops += spmm_out + 2.0 * c * fin * fout           # dhw, gw
        bytes_ += (n * fout + e + 2.0 * c * fout           # du, tiles, dhw
                   + c * fin + fin * fout)                 # comb + gw
        if not first_layer:
            flops += 2.0 * c * fin * fout                  # dcomb = dhw@wᵀ
            bytes_ += fin * fout + c * fin                 # w + write dcomb
    return GcnLayerCost(flops=flops, hbm_bytes=bytes_ * dtype_bytes)


def _nnz_per_layer(nnz_eff, num_layers: int) -> list[float]:
    """Normalize `nnz_eff` to one measured value per layer.

    A scalar is broadcast (the historical uniform-density assumption — the
    propagation matrix is shared across layers, so this is exact when the
    caller passes a MEASURED count); a sequence is taken as per-layer
    measured sparse work and must match the layer count.
    """
    if hasattr(nnz_eff, "__len__"):
        vals = [float(v) for v in nnz_eff]
        if len(vals) != num_layers:
            raise ValueError(
                f"per-layer nnz_eff has {len(vals)} entries for "
                f"{num_layers} layers")
        return vals
    return [float(nnz_eff)] * num_layers


# -- boundary wire pricing (quantized + sliced traffic) ----------------

#: Bytes one boundary-payload row of width f occupies under each wire
#: format — must match the codec layouts in repro_torch.core.codec (the
#: int8/int4 figures include the trailing per-block f32 scale region).
def wire_bytes_per_row(wire: str, f: int, block: int = 128) -> float:
    """Wire bytes of one f-wide boundary row under `wire` (f32 payload)."""
    nb = -(-f // block) if f else 0
    if wire == "f32":
        return 4.0 * f
    if wire == "bf16":
        return 2.0 * f
    if wire == "int8":
        return float(f + 4 * nb)
    if wire == "int4":
        return float((f + 1) // 2 + 4 * nb)
    raise ValueError(f"unknown wire format {wire!r}")


def choose_wire_formats(widths, candidates=("bf16", "int8"),
                        block: int = 128) -> tuple[str, ...]:
    """Per-layer wire format `wire="auto"` resolves to: the candidate with
    the fewest bytes for each payload width, earliest-listed winning ties.

    The default candidate set deliberately leads with bf16 (byte ties
    prefer fidelity) and excludes int4 — its accuracy cost is large enough
    that shipping nibbles stays an explicit per-run decision."""
    out = []
    for f in widths:
        out.append(min(candidates,
                       key=lambda w: (wire_bytes_per_row(w, int(f), block),
                                      candidates.index(w))))
    return tuple(out)


#: Comm-to-compute exchange rate for the order/wire co-decision: FLOPs one
#: wire byte is worth on the paper-normalized GPU (sustained matmul
#: throughput / link bandwidth: 13.45e12 * 0.22 flops over 4e9 B/s, the
#: JAX package's figure, kept so that both packages pick the same orders).
DEFAULT_FLOPS_PER_WIRE_BYTE = 13.45e12 * 0.22 / 4e9


def gcn_order_report(layer_dims, num_rows: int, combined: int,
                     nnz_eff, train: bool = True,
                     fused: bool = False, tile: int = _TILE,
                     slot_rows: float = 0.0, wire_bytes_fn=None,
                     slice_boundary: bool = False,
                     comm_flops_per_byte: float = 0.0) -> list[dict]:
    """Per-layer cost table: {order: GcnLayerCost} + the argmin choice.

    `layer_dims` is ``ModelConfig.layer_dims()`` — [(fin, fout)] per layer.
    `nnz_eff` is the measured effective sparse multiply-adds per feature
    column — a scalar (broadcast to every layer) or a per-layer sequence;
    for the tile engines pass the measured post-layout tile count × T²
    (PipeGCN.layer_orders does), NOT a uniform-density estimate — a
    reordered graph has measurably fewer tiles and the argmin can differ.
    The choice minimizes FLOPs; HBM bytes break exact FLOP ties (and are
    reported for the roofline-minded reader either way). Callers with the
    real kernel tile size in hand pass it through — it prices the fused
    backward's prologue recompute.

    Boundary-byte pricing (all off by default, so the classic FLOP argmin
    is unchanged): with `slot_rows` (boundary rows per exchange payload,
    P·slot per partition) and `comm_flops_per_byte` > 0, each order is
    charged `comm_flops_per_byte × wire_bytes` in the argmin key, where
    wire_bytes prices the payload width that order ships — fin, or fout
    under transform-first when `slice_boundary` and fout <= fin (layer 0
    always ships fin: its payload is the raw input) — through
    `wire_bytes_fn(layer, width)` (default: 4 bytes/element), once forward
    plus once backward for trained layers > 0. The per-order byte figure
    lands in the report as "wire_bytes" either way."""
    per_layer_nnz = _nnz_per_layer(nnz_eff, len(layer_dims))
    if wire_bytes_fn is None:
        wire_bytes_fn = lambda ell, f: 4.0 * f     # noqa: E731
    out = []
    for ell, (fin, fout) in enumerate(layer_dims):
        costs = {}
        wire_bytes = {}
        for order in GCN_ORDERS:
            costs[order] = gcn_layer_order_cost(
                order, fin, fout, num_rows, combined, per_layer_nnz[ell],
                first_layer=(ell == 0), train=train,
                fused=(fused and order == "aggregate-first"), tile=tile)
            width = (fout if (slice_boundary and ell > 0 and fout <= fin
                              and order == "transform-first") else fin)
            n_dir = 1 + (1 if train and ell > 0 else 0)
            wire_bytes[order] = slot_rows * wire_bytes_fn(ell, width) * n_dir
        chosen = min(GCN_ORDERS,
                     key=lambda o: (costs[o].flops
                                    + comm_flops_per_byte * wire_bytes[o],
                                    costs[o].hbm_bytes))
        out.append({"layer": ell, "costs": costs, "chosen": chosen,
                    "wire_bytes": wire_bytes})
    return out


def choose_gcn_orders(layer_dims, num_rows: int, combined: int,
                      nnz_eff, train: bool = True,
                      fused: bool = False,
                      tile: int = _TILE, **wire_kw) -> tuple[str, ...]:
    """The static per-layer ordering the "auto" matmul_order resolves to.

    `nnz_eff` follows `gcn_order_report`: scalar or per-layer measured
    sparse work (tile count × T² for the tile engines); `wire_kw` passes
    the boundary-byte pricing knobs through (slot_rows / wire_bytes_fn /
    slice_boundary / comm_flops_per_byte)."""
    return tuple(r["chosen"] for r in gcn_order_report(
        layer_dims, num_rows, combined, nnz_eff, train=train, fused=fused,
        tile=tile, **wire_kw))


# ----------------------------------------------------------------------
# Graph-layout report: how well a PartitionedGraph's intra-partition node
# order packs the tile frontier the block-sparse engines pay for. Consumed
# by the trainer log line, benchmarks/bench_kernels.run_reorder_sweep (the
# BENCH_*.json natural-vs-rcm record + gate), and tests/test_reorder.py.
# ----------------------------------------------------------------------

def graph_layout_report(pg, tile: int = _TILE) -> dict:
    """Layout-quality metrics of the padded partition shards.

    Per partition (and aggregated):
      tiles       nonempty tile×tile blocks of the local [P_in | P_bd]
                  shard (TRUE count over real edges — no padding, no
                  zero fillers; the quantity the reorder shrinks)
      bandwidth   max |row − col| over intra-partition edges (the RCM
                  objective); `mean_bandwidth` alongside
      halo_rows   rows with at least one halo-column edge
      halo_runs   maximal contiguous runs of those rows — 1 means the halo
                  frontier is perfectly clustered
      bnd_tiles   nonempty tiles whose output rows land in the boundary
                  tail (row block >= the split-phase cut b0) — the
                  critical-path prefix the split schedule must run BEFORE
                  issuing the exchange; when the split is infeasible the
                  whole stream is the prefix (bnd_tiles == tiles)
    Aggregated: `bnd_tile_share` = Σbnd_tiles / Σtiles (the fraction of
    sparse work that is NOT overlappable — 1.0 when infeasible), so the
    reorder sweep shows how much of the tile stream each layout exposes
    to the split-phase overlap.
    """
    from repro_torch.graph.halo import boundary_row_split
    split = boundary_row_split(pg, tile)
    b0 = split["b0"] if split["feasible"] else 0
    combined = pg.max_inner + pg.num_parts * pg.slot
    ncb = -(-combined // tile)
    per = []
    for i in range(pg.num_parts):
        keep = pg.edge_w[i] != 0
        row = pg.edge_row[i][keep].astype(np.int64)
        col = pg.edge_col[i][keep].astype(np.int64)
        tile_ids = np.unique((row // tile) * ncb + (col // tile))
        tiles = len(tile_ids)
        intra = col < pg.max_inner
        span = np.abs(row[intra] - col[intra])
        halo_rows = np.unique(row[~intra])
        per.append({
            "tiles": int(tiles),
            "bnd_tiles": int(np.sum(tile_ids // ncb >= b0)
                             if split["feasible"] else tiles),
            "bandwidth": int(span.max()) if span.size else 0,
            "mean_bandwidth": float(span.mean()) if span.size else 0.0,
            "halo_rows": int(len(halo_rows)),
            "halo_runs": (int(np.sum(np.diff(halo_rows) > 1) + 1)
                          if len(halo_rows) else 0),
        })
    tiles_total = sum(p["tiles"] for p in per)
    bnd_total = sum(p["bnd_tiles"] for p in per)
    return {
        "layout": getattr(pg, "layout", "natural"),
        "tile": tile,
        "per_partition": per,
        "tiles": tiles_total,
        "bandwidth": max(p["bandwidth"] for p in per),
        "mean_bandwidth": float(np.mean([p["mean_bandwidth"] for p in per])),
        "halo_runs": sum(p["halo_runs"] for p in per),
        "split_feasible": bool(split["feasible"]),
        "bnd_tiles": bnd_total,
        "bnd_tile_share": float(bnd_total / max(tiles_total, 1)),
    }


def split_overlap_report(pg, layer_dims, tile: int = _TILE,
                         dtype_bytes: int = 4) -> list[dict]:
    """Static per-layer price of the split-phase schedule.

    For each layer: the tensor-core FLOPs of the boundary phase (the
    critical-path prefix that must finish before the exchange can be
    issued), the interior-phase FLOPs available to hide the exchange
    behind, and the per-partition bytes each direction puts on the wire
    (forward feature send of width fin; the backward gradient send has the
    same width — layer 0 sends no gradient). `overlappable` is the interior
    share of the padded tile stream — what fraction of the layer's sparse
    work the schedule moves behind the in-flight exchange. Tile counts are
    the PADDED per-partition stream (every partition walks the same stream
    length), from the same memoized extraction the Topology uses; returns
    [] when the split is infeasible for this graph."""
    from repro_torch.graph.halo import extract_partition_tiles
    pt = extract_partition_tiles(pg, tile)
    if pt.fwd_bnd is None:
        return []
    n_tiles = pt.rows.shape[-1]
    wire_rows = pg.num_parts * pg.slot
    out = []
    for ell, (fin, fout) in enumerate(layer_dims):
        tc = 2.0 * tile * tile          # multiply-adds per tile per column
        out.append({
            "layer": ell,
            "bnd_flops": pt.fwd_bnd * tc * fin,
            "int_flops": (n_tiles - pt.fwd_bnd) * tc * fin,
            "t_bnd_flops": pt.t_bnd * tc * fin,
            "t_int_flops": (n_tiles - pt.t_bnd) * tc * fin,
            "wire_bytes": wire_rows * fin * dtype_bytes,
            "grad_wire_bytes": (wire_rows * fin * dtype_bytes
                                if ell > 0 else 0),
            "overlappable": float((n_tiles - pt.fwd_bnd) / n_tiles),
        })
    return out
