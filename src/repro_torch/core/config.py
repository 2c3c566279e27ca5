"""Configuration dataclasses for the PipeGCN core.

Port copy of the JAX package's ``repro.core.config``, whole, so every flag
means the same in both packages. Options this slice of the port does not
run are rejected when a ``PipeGCN`` is built (``repro_torch.core.pipegcn``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """GCN / GraphSAGE model per the paper (§2, Tab. 3)."""

    kind: str = "sage"             # "gcn" (σ(PHW)) or "sage" (σ([PH; H]W))
    feat_dim: int = 128
    hidden: int = 256
    num_layers: int = 4
    num_classes: int = 16
    dropout: float = 0.5
    multilabel: bool = False       # sigmoid BCE (Yelp) vs softmax CE
    # Aggregation engine for the Eq. 3/4 SpMM: "coo" (padded COO: on the
    # card the segment kernel of kernels/coo_spmm.py over the topology's
    # sorted edge views, on the CPU gather + index_add_), "blocksparse"
    # (the CUDA tile kernels; Topology must carry tiles), or
    # "fused" (blocksparse tiles + single-pass aggregate⊗transform kernels
    # with the dense weight contracted in the same grid pass).
    agg: str = "coo"
    # Matmul ordering of the layer pair P·H·W (Demirci et al.: a first-order
    # FLOP knob — P·(H·W) costs 2·nnz·F_out where (P·H)·W costs 2·nnz·F_in):
    #   "aggregate-first"  z = P·H, then u = z·W   (the paper's Eq. 3 order)
    #   "transform-first"  hw = H·W, then u = P·hw
    #   "auto"             per-layer argmin-FLOPs via the static cost model
    #                      (repro_torch.analysis.cost.choose_gcn_orders)
    matmul_order: str = "aggregate-first"
    # Intra-partition node layout the graph pipeline builds the shards with
    # (repro_torch.graph.reorder): "natural" keeps the partitioner's sorted-
    # global-id order; "rcm" applies RCM bandwidth reduction + halo
    # clustering (fewer nonempty tiles for the tile engines, numerically
    # invisible); "auto" — the default — resolves to "rcm" exactly when
    # `agg` consumes tiles at pipeline build (GraphDataPipeline.build
    # takes the same knob). This field declares the layout config-side:
    # train_pipegcn fails fast when an EXPLICIT declaration disagrees
    # with the layout the pipeline was built with, while "auto" defers to
    # the pipeline (any built layout is numerically valid under any
    # engine), so a default-constructed config never trips the check.
    layout: str = "auto"

    ORDERS = ("aggregate-first", "transform-first", "auto")
    LAYOUTS = ("natural", "rcm", "auto")

    def __post_init__(self):
        if self.matmul_order not in self.ORDERS:
            raise ValueError(
                f"unknown matmul_order {self.matmul_order!r}; "
                f"have {self.ORDERS}")
        if self.layout not in self.LAYOUTS:
            raise ValueError(
                f"unknown layout {self.layout!r}; have {self.LAYOUTS}")

    def layer_dims(self) -> list[tuple[int, int]]:
        """[(fan_in_of_aggregated, fan_out)] per layer (pre-concat dims)."""
        dims = [self.feat_dim] + [self.hidden] * (self.num_layers - 1) + [self.num_classes]
        return [(dims[i], dims[i + 1]) for i in range(self.num_layers)]


@dataclasses.dataclass(frozen=True)
class PipeConfig:
    """Staleness / smoothing switches.

    stale=False                       -> vanilla partition-parallel training
    stale=True                        -> PipeGCN
    stale=True + smooth_grad (γ)      -> PipeGCN-G
    stale=True + smooth_feat (γ)      -> PipeGCN-F
    stale=True + both                 -> PipeGCN-GF
    """

    stale: bool = True
    smooth_feat: bool = False
    smooth_grad: bool = False
    gamma: float = 0.95            # paper default decay rate
    # DEPRECATED alias for wire="bf16" (the original App. C bf16 switch).
    # Setting it normalizes `wire` below; new code should set `wire`.
    compress_boundary: bool = False
    # Boundary wire format (repro.core.codec): what every exchanged
    # feature/gradient payload is encoded to on the wire. "f32" (default)
    # ships the native dtype; "bf16" halves the bytes (the old
    # compress_boundary); "int8"/"int4" are blockwise-scaled quantization
    # (~4x/~8x smaller, per-`wire_block` f32 scales ride in the payload);
    # "auto" picks per layer via the cost model's byte pricing
    # (repro.analysis.cost.choose_wire_formats — int4 stays explicit-only).
    wire: str = "f32"
    # Feature-block size of the quantized scale vectors: one f32 scale per
    # `wire_block` feature columns (per boundary row). Only int8/int4 use it.
    wire_block: int = 128
    # Feature-dimension slicing ("Slicing Input Features...", arXiv
    # 2408.11500): layers the cost model runs transform-first ship the
    # post-transform width F_out <= F_in — the consumer aggregates the
    # already-transformed halo rows. Exact for vanilla/eval; under
    # staleness the halo transform uses last step's weights (same
    # one-iteration-stale contract as the features themselves). Layer 0
    # always ships raw input features; incompatible with overlap=
    # "split-phase" (slicing moves the send after the transform, so the
    # boundary-first phase split has nothing to overlap).
    slice_boundary: bool = False
    # Beyond-paper (App. C "increase the pipeline depth" future work):
    # consume boundary data from k iterations ago — k-1 extra iterations of
    # compute available to hide one exchange. k=1 is the paper's PipeGCN.
    staleness_steps: int = 1
    # Fused deferred exchange: in stale mode the exchanged boundary payloads
    # are only consumed at step t+1 (Alg. 1), so per-layer sends can be
    # packed along the feature axis and shipped in ONE collective per
    # direction (1 forward + 1 backward vs 2L-1 blocking per-layer
    # collectives), scheduled off the critical path. Numerically identical
    # to the per-layer schedule; no effect when stale=False (vanilla mode
    # needs fresh per-layer exchanges on the critical path).
    fuse_exchange: bool = True
    # Split-phase overlap (ISSUE 6): compute the boundary-phase SpMM (the
    # halo-clustered tail runs of the rcm tile stream) first, issue the
    # exchange for the NEXT consumer immediately, and run the interior
    # phase — the bulk of the aggregation — while the collective is in
    # flight. "none" keeps the unsplit schedule; "split-phase" forces the
    # split (requires a PipeGCN built with a SplitSpec — see
    # repro.core.pipegcn.split_spec_from); "auto" (default) enables it exactly
    # when a split spec is available AND the aggregation engine consumes
    # tiles (the engines whose streams the phase split actually
    # reorders). Numerically the split is bit-identical to the unsplit
    # schedule; it only repositions each collective between the two
    # phases (collective COUNTS are unchanged in every mode).
    overlap: str = "auto"
    # Guarded exchange (ISSUE 9): append a per-row checksum column to every
    # wire payload (docs/wire-format.md §2.2) and verify it on decode. A
    # row that fails verification is treated as lost: the receiver falls
    # back to its last-good stale entry, so the payload's EFFECTIVE
    # staleness grows by one. Buffers gain an "es" counter leaf tracking
    # consecutive fallbacks per (partition, direction, layer, peer); the
    # trainer raises faults.StalenessExceededError once
    # staleness_steps + max(es) exceeds `max_staleness`. With no faults
    # injected the guard is bitwise invisible (select semantics) and adds
    # no collectives. Requires stale=True — vanilla mode has no stale
    # buffer to fall back to.
    guard_exchange: bool = False
    # Bound on the effective staleness the guarded run tolerates before
    # dying loudly (PipeGCN's convergence proof assumes bounded staleness;
    # unbounded fallback would silently void it).
    max_staleness: int = 8

    OVERLAPS = ("auto", "none", "split-phase")
    WIRES = ("f32", "bf16", "int8", "int4", "auto")

    def __post_init__(self):
        if self.overlap not in self.OVERLAPS:
            raise ValueError(
                f"unknown overlap {self.overlap!r}; have {self.OVERLAPS}")
        if self.wire not in self.WIRES:
            raise ValueError(
                f"unknown wire {self.wire!r}; have {self.WIRES}")
        if self.wire_block < 1:
            raise ValueError(f"wire_block must be >= 1, got {self.wire_block}")
        if self.compress_boundary:
            if self.wire == "f32":
                object.__setattr__(self, "wire", "bf16")
            elif self.wire != "bf16":
                raise ValueError(
                    "compress_boundary is a deprecated alias for wire='bf16' "
                    f"and conflicts with wire={self.wire!r}")
        if self.guard_exchange:
            if not self.stale:
                raise ValueError(
                    "guard_exchange requires stale=True: vanilla mode has "
                    "no stale buffer to fall back to when a payload fails "
                    "its checksum")
            if self.overlap == "split-phase":
                raise ValueError(
                    "guard_exchange is incompatible with overlap="
                    "'split-phase' (the split schedule lands payloads "
                    "mid-phase, before the checksum verdict exists); use "
                    "overlap='auto'/'none'")
            if self.max_staleness < self.staleness_steps:
                raise ValueError(
                    f"max_staleness ({self.max_staleness}) must be >= "
                    f"staleness_steps ({self.staleness_steps}): the FIFO "
                    "depth alone already implies that much staleness")
        if self.slice_boundary and self.overlap == "split-phase":
            raise ValueError(
                "slice_boundary is incompatible with overlap='split-phase' "
                "(the sliced send happens after the transform, leaving no "
                "boundary-first phase to overlap); use overlap='auto'/'none'")

    @property
    def fused(self) -> bool:
        """Whether the step actually runs the fused-deferred schedule."""
        return self.stale and self.fuse_exchange

    @staticmethod
    def vanilla() -> "PipeConfig":
        return PipeConfig(stale=False)

    @staticmethod
    def named(name: str, gamma: float = 0.95) -> "PipeConfig":
        name = name.lower()
        table = {
            "gcn": PipeConfig(stale=False),
            "vanilla": PipeConfig(stale=False),
            "pipegcn": PipeConfig(stale=True),
            "pipegcn-g": PipeConfig(stale=True, smooth_grad=True, gamma=gamma),
            "pipegcn-f": PipeConfig(stale=True, smooth_feat=True, gamma=gamma),
            "pipegcn-gf": PipeConfig(stale=True, smooth_feat=True,
                                     smooth_grad=True, gamma=gamma),
        }
        if name not in table:
            raise KeyError(f"unknown variant {name!r}; have {sorted(table)}")
        return table[name]
