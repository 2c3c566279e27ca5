"""Partitioned-graph construction: per-partition padded arrays + halo
(boundary-exchange) descriptors, ready for SPMD execution.

Port copy of the JAX package's ``repro.graph.halo`` (numpy only): the
port imports nothing of ``repro``, and the two must build byte-identical
arrays (tests/test_torch_graph.py).

Terminology follows the paper (Alg. 1):
  inner nodes  V_i : nodes owned by partition i
  boundary set B_i : remote nodes partition i needs (its halo)
  S_{i,j} = B_j ∩ V_i : nodes partition i must SEND to partition j

All arrays are padded to identical sizes across partitions so a single SPMD
program (shard_map over the partition axis) can execute every partition:

  inner features   X        (P, max_inner, F)
  adjacency (COO)  row/col/w (P, max_nnz)   col indexes the COMBINED array
  send indices     send_idx (P, P, slot)    local inner row to send to peer j
  halo buffer      B        (P, P*slot, F)  received boundary features

The combined feature array of partition i is  [H_inner (max_inner) ; B (P*slot)],
so one sparse matmul implements  P_in·H + P_bd·B  exactly (Eq. 3): intra-
partition edges point at columns < max_inner, boundary edges at
max_inner + j*slot + k.  Padded edges carry weight 0 and point at column 0.
COO (padded to max_nnz) rather than ELL keeps memory bounded under power-law
degree skew.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class PartitionedGraph:
    """Padded per-partition graph shards (leading axis = partition).

    `layout` records the intra-partition node ordering the shards were
    built with ("natural" = sorted global id; "rcm" = bandwidth-reduced +
    halo-clustered, see repro_torch.graph.reorder). `perm`/`inv_perm` are the
    per-partition permutations relating the two: `perm[i, k]` is the
    NATURAL local row of the node at reordered local row k, and
    `inv_perm` its inverse (both identity under the natural layout; -1 in
    the padding tail). Every consumer that routes through
    `part_of`/`local_of` — pack/unpack, the send/recv index tables, the
    COO and tile shards — already lives in the reordered space, so the
    permutation is only ever applied at build time and undone at the
    eval/metric boundary by `unpack_nodes`.
    """

    num_parts: int
    num_nodes: int                 # global node count
    max_inner: int
    slot: int                      # per-(i,j) halo slot count (uniform)
    max_nnz: int

    part_of: np.ndarray            # (N,) int32 owner partition
    local_of: np.ndarray           # (N,) int32 local inner row at owner
    inner_global: np.ndarray       # (P, max_inner) int32, -1 pad
    inner_mask: np.ndarray         # (P, max_inner) bool

    edge_row: np.ndarray           # (P, max_nnz) int32 local dst row
    edge_col: np.ndarray           # (P, max_nnz) int32 combined-array col
    edge_w: np.ndarray             # (P, max_nnz) float32 (0 = pad)

    send_idx: np.ndarray           # (P, P, slot) int32 local inner row, 0 pad
    send_mask: np.ndarray          # (P, P, slot) bool
    halo_owner_mask: np.ndarray    # (P, P*slot) bool: real halo entries of part i

    layout: str = "natural"        # intra-partition node ordering
    perm: np.ndarray | None = None      # (P, max_inner) int32: new -> natural
    inv_perm: np.ndarray | None = None  # (P, max_inner) int32: natural -> new
    # build_tile_topology output per tile size (see extract_partition_tiles):
    # trainer + dryrun + benchmarks in one process reuse one extraction.
    tile_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def combined(self) -> int:
        """Size of the combined per-partition feature array."""
        return self.max_inner + self.num_parts * self.slot

    def pack_nodes(self, x: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Scatter a global (N, ...) array into (P, max_inner, ...)."""
        out_shape = (self.num_parts, self.max_inner) + x.shape[1:]
        out = np.full(out_shape, fill, dtype=x.dtype)
        out[self.part_of, self.local_of] = x
        return out

    def unpack_nodes(self, x: np.ndarray) -> np.ndarray:
        """Gather (P, max_inner, ...) back to global (N, ...)."""
        return np.asarray(x)[self.part_of, self.local_of]

    # -- statistics used by benchmarks ---------------------------------
    def halo_counts(self) -> np.ndarray:
        """(P,) number of real boundary nodes per partition."""
        return self.halo_owner_mask.reshape(self.num_parts, -1).sum(axis=1)

    def boundary_bytes_per_layer(self, feat_dim: int, dtype_bytes: int = 4) -> int:
        """Total payload exchanged per layer per direction (fwd or bwd)."""
        return int(self.send_mask.sum()) * feat_dim * dtype_bytes

    def padding_ratio(self) -> float:
        real = self.send_mask.sum()
        padded = self.send_mask.size
        return float(1.0 - real / max(padded, 1))


@dataclasses.dataclass
class PartitionTiles:
    """Stacked block-sparse tile streams, one row per partition.

    Built by `extract_partition_tiles` from the padded COO shards without
    ever materializing a dense matrix. All partitions are padded to the same
    tile count with zero tiles so the arrays stack into a leading partition
    axis (SPMD-ready, mirroring the COO shard layout). `t_*` arrays drive
    the transpose kernel (δcomb = Pᵀ·δz) over the same `vals` storage.
    """

    rows: np.ndarray      # (P, n_tiles) int32 row block, sorted per part
    cols: np.ndarray      # (P, n_tiles) int32 col block
    vals: np.ndarray      # (P, n_tiles, T, T) float32
    t_out: np.ndarray     # (P, n_tiles) int32 Pᵀ output block, sorted
    t_in: np.ndarray      # (P, n_tiles) int32 Pᵀ input block
    t_perm: np.ndarray    # (P, n_tiles) int32 per-partition index into vals

    # Interior/boundary phase split of the streams (split-phase overlap
    # schedule). None when the split is structurally infeasible (no sends,
    # or boundary rows start in row block 0 on every partition) — the
    # streams then carry the plain tail padding and only the unsplit
    # schedule may consume them. When set, the LAST fwd_bnd (t_bnd) slots
    # of every partition's forward (transpose) stream are exactly the
    # tiles with row block >= b0 (col block >= hb0) — uniform cut points,
    # enforced by the phase-aware group padding.
    b0: int | None = None       # first boundary row block (fwd phases)
    hb0: int | None = None      # first boundary col block (transpose phases)
    fwd_bnd: int | None = None  # boundary-suffix tiles, forward stream
    t_bnd: int | None = None    # boundary-suffix tiles, transpose stream

    @property
    def n_tiles(self) -> int:
        return self.rows.shape[1]


def boundary_row_split(pg: "PartitionedGraph", tile: int = 128) -> dict:
    """Interior/boundary row split of each partition's reordered node range.

    `first_send[i]` is the lowest local row partition i ever sends (== the
    head of its halo-clustered tail run under the rcm layout; scattered —
    usually 0 — under the natural layout). The split-phase schedule cuts
    uniformly at row block ``b0 = min_i first_send[i] // tile`` (forward)
    and col block ``hb0 = max_inner // tile`` (transpose: everything at or
    above the last full inner block feeds the gradient send or the halo).
    Partitions with no sends at all report first_send = max_inner and do
    not constrain b0 (degenerate single-partition case: every first_send
    is max_inner and `feasible` is False).
    """
    firsts = []
    for i in range(pg.num_parts):
        rows = pg.send_idx[:, i, :][pg.send_mask[:, i, :]]
        firsts.append(int(rows.min()) if rows.size else pg.max_inner)
    has_sends = bool(pg.send_mask.any())
    b0 = min(f // tile for f in firsts)
    hb0 = pg.max_inner // tile
    return {"first_send": firsts, "b0": b0, "hb0": hb0, "tile": tile,
            "feasible": has_sends and b0 >= 1 and hb0 >= 1
            and b0 * tile < pg.max_inner}


def extract_partition_tiles(pg: "PartitionedGraph",
                            tile: int | None = None) -> PartitionTiles:
    """Per-partition TILE×TILE tile extraction for the blocksparse engine.

    Each partition's padded COO shard (rows over inner nodes, columns over
    the combined [inner; halo] array) is bucketed into dense MXU-shaped
    tiles directly — O(nnz + n_tiles·T²), no dense (max_inner, combined)
    intermediate. Padded edges (weight 0) are dropped by the bucketing.

    The result is memoized on ``pg.tile_cache`` (keyed by tile size): the
    shards are immutable after build, and one process routinely constructs
    several engines over the same graph (trainer + eval + dryrun +
    benchmark sweeps), which would otherwise re-extract identical tiles.

    When the interior/boundary split is structurally feasible (see
    `boundary_row_split`) the cross-partition padding is PHASE-AWARE: each
    partition's streams are padded per phase group, so the boundary suffix
    starts at the same static slot everywhere and the split-phase overlap
    schedule can slice it with trace-time constants. The padded streams
    remain valid for the unsplit kernels (zero tiles, run grouping
    intact), so split and unsplit schedules share one topology
    bit-identically. Infeasible graphs fall back to the plain tail
    padding and report `fwd_bnd is None`.
    """
    from repro_torch.kernels.gcn_spmm import (TILE, build_tile_topology,
                                        pad_tile_topology,
                                        pad_tile_topology_phased)
    tile = TILE if tile is None else tile
    cached = pg.tile_cache.get(tile)
    if cached is not None:
        return cached
    per = [build_tile_topology(pg.edge_row[i], pg.edge_col[i], pg.edge_w[i],
                               pg.max_inner, pg.combined, tile)
           for i in range(pg.num_parts)]
    split = boundary_row_split(pg, tile)
    meta: dict = dict(b0=None, hb0=None, fwd_bnd=None, t_bnd=None)
    if split["feasible"]:
        b0, hb0 = split["b0"], split["hb0"]
        cuts_f = [int(np.searchsorted(tt.rows, b0)) for tt in per]
        cuts_t = [int(np.searchsorted(tt.t_out, hb0)) for tt in per]
        n_int_f = max(cuts_f)
        n_bnd_f = max(tt.n_tiles - c for tt, c in zip(per, cuts_f))
        n_int_t = max(cuts_t)
        n_bnd_t = max(tt.n_tiles - c for tt, c in zip(per, cuts_t))
        # Both streams of one partition share the vals storage, so their
        # padded totals must agree; absorb the difference into the larger
        # schedule's interior group (pads there are cheapest to place).
        n_tiles = max(n_int_f + n_bnd_f, n_int_t + n_bnd_t)
        n_int_f += n_tiles - (n_int_f + n_bnd_f)
        n_int_t += n_tiles - (n_int_t + n_bnd_t)
        per = [pad_tile_topology_phased(tt, b0, hb0, n_int_f, n_bnd_f,
                                        n_int_t, n_bnd_t) for tt in per]
        meta = dict(b0=b0, hb0=hb0, fwd_bnd=n_bnd_f, t_bnd=n_bnd_t)
    else:
        n_tiles = max(tt.n_tiles for tt in per)
        per = [pad_tile_topology(tt, n_tiles) for tt in per]
    out = PartitionTiles(
        rows=np.stack([tt.rows for tt in per]),
        cols=np.stack([tt.cols for tt in per]),
        vals=np.stack([tt.vals for tt in per]),
        t_out=np.stack([tt.t_out for tt in per]),
        t_in=np.stack([tt.t_in for tt in per]),
        t_perm=np.stack([tt.t_perm for tt in per]),
        **meta)
    pg.tile_cache[tile] = out
    return out


def build_partitioned_graph(prop: CSRGraph, part: np.ndarray,
                            num_parts: int | None = None,
                            pad_multiple: int = 8,
                            layout: str = "natural") -> PartitionedGraph:
    """Build padded partition shards from a normalized propagation matrix.

    `prop` must already be normalized (weights = global P entries) so that
    the partition split preserves Eq. 3/4 semantics exactly.

    `layout` selects the intra-partition node ordering:
      "natural"  sorted global id (the historical order)
      "rcm"      RCM bandwidth reduction over the local subgraph + halo
                 clustering (repro_torch.graph.reorder.partition_orders), and the
                 halo slots of each (receiver i, owner j) pair additionally
                 sorted by the first reordered row of i that consumes them —
                 together they shrink the nonempty-tile frontier the
                 block-sparse engines pay for. Numerically the layouts are
                 identical modulo the carried `perm`/`inv_perm`.
    """
    part = np.asarray(part, dtype=np.int32)
    n = prop.num_nodes
    p = int(part.max()) + 1 if num_parts is None else int(num_parts)

    # Local ordering of inner nodes: sorted global id, or the reordered
    # per-partition node lists. Everything downstream keys off
    # part_of/local_of, so the layout choice is fully absorbed here.
    if layout == "natural":
        inner_lists = [np.flatnonzero(part == i) for i in range(p)]
    elif layout == "rcm":
        from repro_torch.graph.reorder import partition_orders
        inner_lists = partition_orders(prop, part, p)
    else:
        from repro_torch.graph.reorder import LAYOUTS
        raise ValueError(f"unknown layout {layout!r}; have {LAYOUTS}")
    local_of = np.zeros(n, dtype=np.int32)
    for i in range(p):
        local_of[inner_lists[i]] = np.arange(len(inner_lists[i]),
                                             dtype=np.int32)
    inner_counts = np.array([len(v) for v in inner_lists])
    max_inner = int(-(-int(inner_counts.max()) // pad_multiple) * pad_multiple)

    inner_global = np.full((p, max_inner), -1, dtype=np.int32)
    inner_mask = np.zeros((p, max_inner), dtype=bool)
    perm = np.full((p, max_inner), -1, dtype=np.int32)
    inv_perm = np.full((p, max_inner), -1, dtype=np.int32)
    for i in range(p):
        k = inner_counts[i]
        inner_global[i, :k] = inner_lists[i]
        inner_mask[i, :k] = True
        # forward/inverse permutation vs the natural (sorted-global-id)
        # order — identity when layout == "natural"
        fwd = np.searchsorted(np.sort(inner_lists[i]), inner_lists[i])
        perm[i, :k] = fwd
        inv_perm[i, fwd] = np.arange(k, dtype=np.int32)

    # Edge lists per partition; boundary slot assignment per (owner j -> i).
    dst_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(prop.indptr))
    src_all = prop.indices.astype(np.int64)
    w_all = prop.weights
    pi = part[dst_all]            # receiving partition of each edge
    pj = part[src_all]            # owning partition of each source

    # slot maps: for partition i and owner j, remote node -> slot k.
    # Natural layout keeps the historical sorted-global-id slot order; the
    # reordered layouts sort each (i, j) halo block by the FIRST reordered
    # row of i that consumes the node (global id as tie-break), so halo
    # columns cluster with their consuming row blocks and the P_bd tile
    # frontier shrinks along the column axis too.
    halo_nodes: list[list[np.ndarray]] = [[None] * p for _ in range(p)]  # type: ignore
    slot = 0
    for i in range(p):
        for j in range(p):
            if i == j:
                continue
            m = (pi == i) & (pj == j)
            uniq = np.unique(src_all[m])
            if layout != "natural" and len(uniq):
                # min consuming row per unique source WITHOUT ufunc.at
                # (the slow buffered scatter path — same finding as the
                # tile-extraction scatter): sort (slot_key, row) pairs and
                # take each group's first element.
                slot_key = np.searchsorted(uniq, src_all[m])
                rows_i = local_of[dst_all[m]].astype(np.int64)
                order = np.lexsort((rows_i, slot_key))
                starts = np.searchsorted(slot_key[order],
                                         np.arange(len(uniq)))
                first_row = rows_i[order][starts]
                uniq = uniq[np.lexsort((uniq, first_row))]
            halo_nodes[i][j] = uniq
            slot = max(slot, len(uniq))
    slot = max(int(-(-slot // pad_multiple) * pad_multiple), pad_multiple)

    send_idx = np.zeros((p, p, slot), dtype=np.int32)
    send_mask = np.zeros((p, p, slot), dtype=bool)
    halo_owner_mask = np.zeros((p, p * slot), dtype=bool)
    # slot_of[i][j]: dict-free vectorized lookup via searchsorted on halo_nodes
    for i in range(p):
        for j in range(p):
            if i == j:
                continue
            uniq = halo_nodes[i][j]
            k = len(uniq)
            if k == 0:
                continue
            # partition j sends these nodes to partition i
            send_idx[j, i, :k] = local_of[uniq]
            send_mask[j, i, :k] = True
            halo_owner_mask[i, j * slot:j * slot + k] = True

    # Per-partition COO with combined-array columns.
    rows_p: list[np.ndarray] = []
    cols_p: list[np.ndarray] = []
    ws_p: list[np.ndarray] = []
    for i in range(p):
        m = pi == i
        d, s, w = dst_all[m], src_all[m], w_all[m]
        row = local_of[d].astype(np.int64)
        col = np.empty(len(s), dtype=np.int64)
        is_local = part[s] == i
        col[is_local] = local_of[s[is_local]]
        for j in range(p):
            if j == i:
                continue
            mj = (~is_local) & (part[s] == j)
            if not mj.any():
                continue
            uniq = halo_nodes[i][j]
            # slot-of lookup valid for ANY slot order: search the sorted
            # view, then map the sorted position back to the slot index
            by_gid = np.argsort(uniq, kind="stable")
            k = by_gid[np.searchsorted(uniq[by_gid], s[mj])]
            col[mj] = max_inner + j * slot + k
        rows_p.append(row); cols_p.append(col); ws_p.append(w)

    max_nnz = int(-(-max(len(r) for r in rows_p) // pad_multiple) * pad_multiple)
    edge_row = np.zeros((p, max_nnz), dtype=np.int32)
    edge_col = np.zeros((p, max_nnz), dtype=np.int32)
    edge_w = np.zeros((p, max_nnz), dtype=np.float32)
    for i in range(p):
        k = len(rows_p[i])
        edge_row[i, :k] = rows_p[i]
        edge_col[i, :k] = cols_p[i]
        edge_w[i, :k] = ws_p[i]

    return PartitionedGraph(
        num_parts=p, num_nodes=n, max_inner=max_inner, slot=slot,
        max_nnz=max_nnz, part_of=part, local_of=local_of,
        inner_global=inner_global, inner_mask=inner_mask,
        edge_row=edge_row, edge_col=edge_col, edge_w=edge_w,
        send_idx=send_idx, send_mask=send_mask,
        halo_owner_mask=halo_owner_mask,
        layout=layout, perm=perm, inv_perm=inv_perm)
