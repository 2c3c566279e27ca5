"""Production dry-run: every (arch × input-shape) on the production meshes,
run as rank 0 of a fake process group, recording the collectives the step
issues, its argument bytes, and on the card its peak memory and step time.

Port of the JAX package's ``repro.launch.dryrun``. JAX forces 512 host
devices and lowers and compiles each step with ``NamedSharding``s; here a
fake process group of the mesh's world size (256 or 512) stands in for the
devices (`mesh.fake_process_group`: every collective is a no-op), the
parameters, optimizer state, inputs and caches are DTensors with the
placements of JAX's spec trees, and rank 0's step runs in one of two modes:

  --device meta   abstract: ``meta`` tensors, no memory and no arithmetic;
                  counts the collectives and the bytes (the counterpart
                  of lower + compile)
  --device cuda   the card (the default): rank 0's local program at its
                  true production shapes, with the card's peak memory and
                  step time measured besides. The collectives move
                  nothing, so the values computed mean nothing.

The step runs under ``shardctx.dtensor_ops()``: DTensor's
``implicit_replication`` (the plain tensors the model makes inside the
step, such as positions, masks and scalars, count as replicated) and the
shard-wise forms of the embedding lookup, the vocab projection, the loss
and the attention core. DTensor's sharding propagation chooses every
other op's layout and collectives, where JAX lets GSPMD choose. The
abstract mode's mesh is of cpu device type (its tensors are on meta), on
which DTensor would move a shard to another dim by an all-gather, as gloo
has no all-to-all; the dry-run has it issue the card's all-to-all there
too, so the two modes count the same collectives.

The step's first run, in both modes, goes through `StepMemory`, the
counterpart of XLA's memory analysis: ``argument_size_in_bytes`` counts
the argument leaves some op of the step reads (JAX's ``jax.jit`` drops
the others; ``unused_argument_leaves`` says how many were dropped), and
``temp_size_in_bytes`` is the peak of the bytes the step's own storages
hold at once, so ``bytes_per_device`` (arguments + temporaries, JAX's
key) is the peak live bytes. JAX also counts an int32 scalar that the
port keeps as a Python int (decode's position, Adam's step count): 4
bytes fewer here on those rows. The card mode also measures
``peak_bytes`` (the allocator's peak above what the process held before
the combo) and ``step_ms``. XLA's cost analysis has
no counterpart: the keys ``hlo_*``, ``generated_code_size_in_bytes``,
``compile_s`` (``run_s`` is the first run's seconds) and
``collective_bytes_tpu_wire`` are not produced. `check_rows` holds a
mesh's rows to the gates JAX holds its artifacts to (`check_row` one
row).

Importing this module starts no process group.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --device meta --out dryrun.json
  python -m repro_torch.launch.dryrun --all --shape train_4k --device meta
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import logging
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.analysis.cost import analytic_cost
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.trace_utils import CollectiveCounter
from repro_torch.device import synchronize
from repro_torch.launch.mesh import (HBM_BW, NET_BW, PEAK_FLOPS_BF16,
                                     fake_process_group, make_production_mesh)
from repro_torch.launch.specs import (abstract_caches, abstract_params,
                                      batch_axes, fill_normal, input_specs,
                                      meta_params, with_sharding)
from repro_torch.launch.train import loss_and_grads
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.model import LM
from repro_torch.models.shardctx import (NamedSharding, P, dtensor_ops,
                                         sharding_rules)
from repro_torch.optim import adam


def _fsdp_params(lm: LM, mesh, device="cuda"):
    """ZeRO-3/FSDP layout: every weight sharded over ALL mesh axes on its
    first dimension divisible by the chip count (replicated otherwise).
    Each layer's weights are then all-gathered at use and its gradients
    reduce-scattered, in place of tensor-parallel activation reductions."""
    chips = mesh.size()
    flat = tuple(mesh.mesh_dim_names)

    def spec_of(leaf):
        for dim, size in enumerate(leaf.shape):
            if size % chips == 0:
                return P(*[flat if d == dim else None
                           for d in range(leaf.ndim)])
        return P()
    shapes = meta_params(lm)
    return with_sharding(shapes, tree_map(spec_of, shapes), mesh, device,
                         fill_normal(0))


@contextlib.contextmanager
def _card_alltoall():
    """DTensor redistributes Shard(i) -> Shard(j) by an all-to-all on the
    card, but on a mesh of cpu device type (the abstract mode's, whose
    tensors are on meta) by an all-gather and a chunk, since gloo has no
    all-to-all. Under this context such a mesh issues the card's
    all-to-all op too (its fake kernel gives the meta shapes), so both
    modes count the same collectives."""
    from torch.distributed.tensor import placement_types
    orig = getattr(placement_types, "shard_dim_alltoall", None)
    if orig is None:        # a torch release that routes it elsewhere
        yield
        return

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def reduced_grads(lm: LM, params, batch):
    """(loss, gradients) of ``lm.loss_fn`` by autograd, each gradient
    reduced to its parameter's placements (the data-parallel reduction:
    a gradient left as partial sums would reach the optimizer's f32
    moments unsummed, as JAX's gradients take the parameters' shardings)."""
    loss, grads = loss_and_grads(lm, params, batch)
    return loss, tree_map(
        lambda g, p: g.redistribute(p.device_mesh, p.placements)
        if isinstance(g, DTensor) else g, grads, params)


def _build_step(lm: LM, shape, mesh, fsdp: bool = False, device="cuda"):
    """Returns (fn, example_args) for the mode of this input shape: the
    train step (``loss_fn`` + autograd + one Adam update), the prefill, or
    one decode step at the last position. The serve steps write their
    caches in place (``donate=True``, as the port's serve path runs)."""
    cfg = lm.cfg
    params = (_fsdp_params(lm, mesh, device) if fsdp
              else abstract_params(lm, mesh, device))
    batch = input_specs(cfg, shape, mesh, device,
                        batch_axis=tuple(mesh.mesh_dim_names) if fsdp
                        else None)

    if shape.mode == "train":
        opt = adam(1e-4)
        opt_state = opt.init(params)

        def train_step(params, opt_state, batch):
            loss, grads = reduced_grads(lm, params, batch)
            new_params, new_state = opt.apply(params, grads, opt_state)
            return loss, new_params, new_state

        return train_step, (params, opt_state, batch)

    caches = abstract_caches(lm, shape, mesh, device)
    if shape.mode == "prefill":
        def prefill_step(params, batch, caches):
            with torch.no_grad():
                return lm.prefill(params, batch, caches, donate=True)
        return prefill_step, (params, batch, caches)

    pos = shape.seq_len - 1

    def serve_step(params, token, caches):
        with torch.no_grad():
            return lm.decode_step(params, token, caches, pos, donate=True)

    return serve_step, (params, batch["tokens"], caches)


def variant_for(cfg, shape_name: str):
    """long_500k needs sub-quadratic attention: archs without a native
    sub-quadratic mixer run an explicit sliding-window decode variant
    (window 4096), recorded as a variant."""
    if (shape_name == "long_500k" and cfg.sliding_window == 0
            and cfg.family != "ssm"):
        return dataclasses.replace(cfg, sliding_window=4096), "sw4096"
    return cfg, None


def opt_sharding_rules(mesh):
    """Optimized activation sharding (Megatron-style residual +
    vocab-sharded logits); names without a rule follow DTensor's
    propagation."""
    bx = batch_axes(mesh)
    return {
        "residual": NamedSharding(mesh, P(bx, None, None)),
        "logits": NamedSharding(mesh, P(bx, None, "model")),
        "moe_expert": NamedSharding(mesh, P("model", None, None)),
        # grouped routing: token groups track the data shards
        "moe_tokens": NamedSharding(mesh, P(bx, None, None)),
        "moe_gathered": NamedSharding(mesh, P(bx, "model", None, None)),
    }


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def local_bytes(tree, keep=None) -> int:
    """Bytes of this rank's shards of every tensor in `tree` (of those
    whose entry of `keep`, one per tensor, is true)."""
    xs = _tensors(tree)
    keep = [True] * len(xs) if keep is None else keep
    return sum(_local(x).numel() * _local(x).element_size()
               for x, k in zip(xs, keep) if k)


# ops that read only their arguments' metadata (shape, dtype, device)
_METADATA_ONLY = frozenset(
    ["empty_like", "zeros_like", "ones_like", "full_like", "rand_like",
     "randn_like", "new_empty", "new_empty_strided", "new_zeros", "new_ones",
     "new_full"])
# in-place ops that overwrite their first argument without reading it
_OVERWRITES = frozenset(["copy_", "fill_", "zero_"])
# ops whose result holds their first argument's memory under a storage of
# its own on the card (a functional collective's result, wrapped for
# autograd or waited on)
_ALIASES = frozenset(["_wrap_tensor_autograd", "wait_tensor"])


def _storage(t):
    return t.untyped_storage()


def _span(t) -> tuple:
    """The byte range [lo, hi) of its storage that tensor `t` spans."""
    lo = t.storage_offset() * t.element_size()
    if t.numel() == 0:
        return lo, lo
    n = 1 + sum((size - 1) * stride for size, stride in zip(t.shape,
                                                             t.stride()))
    return lo, lo + n * t.element_size()


def _covered(span, ranges) -> bool:
    """Whether the byte range `span` lies within the union of `ranges`."""
    lo, hi = span
    for a, b in sorted(ranges):
        if a <= lo < b:
            lo = b
    return lo >= hi


class StepMemory(TorchDispatchMode):
    """What a step does with memory on this rank, seen op by op (each
    DTensor op as the local ops it runs, forward and backward): which of
    the step's argument storages some op reads, and the peak of the bytes
    of the storages the step makes that are alive at once (each counted
    from the op that makes it until it dies, by a finaliser on the
    storage). Works on ``meta`` tensors, where nothing is allocated, and on
    the card.

    A read is any op but a view (which reads nothing itself: the ops that
    read the view do), one that reads only metadata (``empty_like``,
    ``new_zeros``, ...), a store into an argument (``copy_``, ``fill_``,
    ``zero_`` into it, as a cache layer the step replaces whole), and a
    read of entries such a store wrote before: JAX drops an argument whose
    new value the step computes without it from the compiled step, as it
    drops one the step never uses. An assignment into an argument
    (``x[:, a:b] = y``, JAX's ``dynamic_update_slice``, which passes the
    other entries through) is a read: `assignments()` gives the function
    mode that sees it."""

    def __init__(self, args):
        super().__init__()
        # the arguments' storages (kept alive by the caller: holding them
        # here would keep them past the step)
        self.args = {id(_storage(_local(x))) for x in _tensors(args)}
        self.read: set = set()
        self.live = self.peak = 0
        # id(storage) -> [bytes, storages alive] of the memory it holds
        self._made: dict = {}
        self._stored: dict = {}         # id(storage) -> [(lo, hi)] stored

    def _free(self, key: int):
        held = self._made.pop(key, None)
        if held is not None:
            held[1] -= 1
            if held[1] == 0:
                self.live -= held[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if DTensor in types:
            # let DTensor turn the op into local ops, which come back here
            return NotImplemented
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if not func.is_view and name not in _METADATA_ONLY:
            ins = _tensors((args, kwargs))
            if name in _OVERWRITES and ins:
                dst, ins = ins[0], ins[1:]
                key, (lo, hi) = id(_storage(dst)), _span(dst)
                if key in self.args and (hi - lo) == \
                        dst.numel() * dst.element_size():
                    self._stored.setdefault(key, []).append((lo, hi))
                else:
                    ins = [dst] + ins
            for t in ins:
                key = id(_storage(t))
                if key in self.args and not _covered(
                        _span(t), self._stored.get(key, ())):
                    self.read.add(key)
        out = func(*args, **kwargs)
        src = _tensors(args)[:1] if name in _ALIASES else []
        held = self._made.get(id(_storage(src[0]))) if src else None
        for t in _tensors(out):
            if isinstance(t, FakeTensor):
                continue        # DTensor's sharding propagation's
            st = _storage(t)
            key = id(st)
            if key in self.args or key in self._made:
                continue
            if held is None:
                held = [st.nbytes(), 0]
                self.live += held[0]
                self.peak = max(self.peak, self.live)
            held[1] += 1
            self._made[key] = held
            weakref.finalize(st, self._free, key)
            held = None
        return out

    def assignments(self):
        """A function mode under which each ``x[key] = y`` into an argument
        counts as a read of it."""
        mem = self

        class Assignments(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func is torch.Tensor.__setitem__ and \
                        isinstance(args[0], torch.Tensor):
                    key = id(_storage(_local(args[0])))
                    if key in mem.args:
                        mem.read.add(key)
                return func(*args, **(kwargs or {}))
        return Assignments()

    def read_leaves(self, args) -> list:
        """Of the argument leaves (tensors of `args`), whether some op of
        the step read each one's storage."""
        return [id(_storage(_local(x))) in self.read for x in _tensors(args)]


def _quiet_dtensor_logs():
    """DTensor warns on every suboptimal redistribution and the fake
    group's CPU fallbacks; the dry-run reports what it issues instead."""
    for name in ("torch.distributed.tensor._redistribute",
                 "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)


def dryrun_one(arch_id: str, shape_name: str, multi_pod: bool = False,
               lower_only: bool = False, opt_sharding: bool = False,
               fsdp: bool = False, device: str = "cuda",
               steps: int = 3) -> dict:
    """One combo on the production mesh, as rank 0 of a fake process group
    of the mesh's world size (started here, destroyed on return). On a
    device (cuda, or cpu for small tests) the step runs once under the
    collective counter, then `steps` more times timed, with the peak
    memory of those runs."""
    _quiet_dtensor_logs()
    shape = INPUT_SHAPES[shape_name]
    cfg, variant = variant_for(get_arch(arch_id), shape_name)
    chips = 512 if multi_pod else 256
    dev = torch.device(device)
    base = allocated(dev)
    with fake_process_group(chips), _card_alltoall():
        mesh = make_production_mesh(
            multi_pod=multi_pod,
            device_type="cpu" if dev.type == "meta" else dev.type)
        rules = opt_sharding_rules(mesh) if opt_sharding else None
        if fsdp:
            flat = tuple(mesh.mesh_dim_names)
            rules = {"residual": NamedSharding(mesh, P(flat, None, None)),
                     "logits": NamedSharding(mesh, P(flat, None, None))}
        if opt_sharding and cfg.num_experts:
            data_shards = mesh.size(mesh.mesh_dim_names.index("data")) * (
                2 if multi_pod else 1)
            cfg = dataclasses.replace(cfg, moe_groups=data_shards)
        lm = LM(cfg)
        t0 = time.perf_counter()
        with sharding_rules(rules):
            fn, args = _build_step(lm, shape, mesh, fsdp=fsdp, device=dev)
            result = {
                "arch": arch_id, "shape": shape_name, "mode": shape.mode,
                "variant": variant, "opt_sharding": opt_sharding,
                "fsdp": fsdp, "device": dev.type,
                "mesh": "x".join(str(s) for s in mesh.mesh.shape),
                "chips": chips,
                "lower_s": round(time.perf_counter() - t0, 1),
                "argument_size_in_bytes": local_bytes(args),
            }
            if lower_only:
                return result
            t1 = time.perf_counter()
            mem = StepMemory(args)
            with dtensor_ops(cfg.padded_vocab), CollectiveCounter() as cc, \
                    mem, mem.assignments():
                out = fn(*args)
            synchronize(dev)
            result["run_s"] = round(time.perf_counter() - t1, 3)
            read = mem.read_leaves(args)
            result["argument_size_in_bytes"] = local_bytes(args, read)
            result["unused_argument_leaves"] = read.count(False)
            result["output_size_in_bytes"] = local_bytes(out)
            del out
            result["temp_size_in_bytes"] = mem.peak
            result["bytes_per_device"] = (result["argument_size_in_bytes"]
                                          + mem.peak)
            if dev.type != "meta":
                with dtensor_ops(cfg.padded_vocab):
                    result.update(measure(lambda: fn(*args), dev, steps,
                                          base))
    # every collective that ran was counted (no loop body counted once)
    result["while_mult"] = 1
    result["collective_counts_per_device"] = cc.counts
    result["collective_bytes_per_device"] = cc.bytes
    result["collective_total_bytes"] = int(sum(cc.bytes.values()))
    result.update(_roofline(cfg, shape, chips, result["collective_total_bytes"]))
    return result


def allocated(dev: torch.device) -> int:
    """Bytes the card's allocator holds now (0 off the card): what a
    combo's peak is taken from (the memory other code holds)."""
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def measure(step, dev: torch.device, steps: int, base: int = 0) -> dict:
    """Median wall time of `steps` calls of step() (each ended by a device
    sync) and, on the card, the peak memory over them above `base` (the
    bytes held before the step's arguments were made)."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        out = step()
        synchronize(dev)
        times.append((time.perf_counter() - t) * 1e3)
        del out
    times.sort()
    return {"step_ms": times[len(times) // 2], "step_ms_all": times,
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev)) - base
            if cuda else None}


@functools.lru_cache(maxsize=None)
def _cost(cfg, shape) -> tuple:
    """(analytic_cost, active parameters) of a combo: the same for every
    mesh."""
    return analytic_cost(cfg, shape), _active_params(cfg)


def _roofline(cfg, shape, chips: int, coll_bytes: int) -> dict:
    """Analytic FLOPs and HBM bytes per device and the roofline terms on
    the H100 constants (`launch.mesh`), with JAX's keys."""
    ac, active = _cost(cfg, shape)
    flops = ac["flops_global"] / chips
    bytes_hbm = ac["hbm_bytes_global"] / chips
    out = {"flops_per_device": flops, "hbm_bytes_per_device": bytes_hbm,
           "params_total": ac["params_total"],
           "t_compute": flops / PEAK_FLOPS_BF16,
           "t_memory": bytes_hbm / HBM_BW,
           "t_collective": coll_bytes / NET_BW}
    terms = {k: out["t_" + k] for k in ("compute", "memory", "collective")}
    out["bottleneck"] = max(terms, key=terms.get)
    # MODEL_FLOPS (6·N_active·D for train, 2·N_active per token for serve)
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    model_flops = (6 if shape.mode == "train" else 2) * active * tokens
    out["model_flops_total"] = float(model_flops)
    out["model_flops_ratio"] = (float(model_flops / ac["flops_global"])
                                if ac["flops_global"] else 0.0)
    return out


def _active_params(cfg) -> int:
    """Parameter count active per token (MoE counts top-k+shared experts)."""
    from torch.utils._pytree import tree_flatten_with_path
    total = 0
    for path, leaf in tree_flatten_with_path(meta_params(LM(cfg)))[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        n = leaf.numel()
        if cfg.num_experts and any(k in ("wi", "wg", "wo") for k in keys) \
                and leaf.ndim >= 3 and leaf.shape[-3] == cfg.num_experts:
            n = n * cfg.experts_per_tok // cfg.num_experts
        total += n
    return total


BOTTLENECKS = ("compute", "memory", "collective")


def check_row(r, chips: int) -> None:
    """JAX's gates on one row of its dry-run artifacts
    (tests/test_dryrun_artifacts.py): no ``error``; on `chips`, its step
    run (``run_s`` > 0, the counterpart of JAX's ``compile_s``),
    t_compute ≥ 0, t_memory > 0, a bottleneck among `BOTTLENECKS`; a train
    row's model-FLOPs ratio in (0.2, 1.3); no decode row compute-bound. A
    PipeGCN row (``dryrun_pipegcn``'s, arch ``pipegcn-*``) needs its
    all-to-all bytes > 0 instead of the LM rows' keys. Raises
    AssertionError naming the row."""
    tag = (r.get("arch"), r.get("shape"), r.get("mesh"))
    assert "error" not in r, (tag, r.get("error", "")[:300])
    assert r["chips"] == chips, (tag, r["chips"])
    assert r["t_compute"] >= 0 and r["t_memory"] > 0, tag
    assert r["bottleneck"] in BOTTLENECKS, (tag, r["bottleneck"])
    if r["arch"].startswith("pipegcn"):
        assert r["collective_bytes_per_device"]["all-to-all"] > 0, tag
        return
    assert r["run_s"] > 0, (tag, r.get("run_s"))
    if r["mode"] == "train":
        assert 0.2 < r["model_flops_ratio"] < 1.3, (
            tag, r["model_flops_ratio"])
    if r["mode"] == "decode":
        # decode must never be compute-bound at these batch sizes
        assert r["bottleneck"] != "compute", tag


def check_rows(rows, chips: int) -> None:
    """JAX's gates on a mesh's artifacts: one LM row for each of the
    10 archs × 4 shapes, and every row, PipeGCN's among them, through
    `check_row`."""
    errors = [r for r in rows if "error" in r]
    assert not errors, [(r.get("arch"), r.get("shape"), r["error"][:300])
                        for r in errors[:3]]
    lm = [r for r in rows if not r["arch"].startswith("pipegcn")]
    combos = {(r["arch"], r["shape"]) for r in lm}
    assert len(lm) == len(combos) == len(ARCH_IDS) * len(INPUT_SHAPES), \
        (len(lm), len(combos))
    assert {a for a, _ in combos} == set(ARCH_IDS)
    assert {s for _, s in combos} == set(INPUT_SHAPES)
    for r in rows:
        check_row(r, chips)


def skip_reason(arch_id: str, shape_name: str) -> str | None:
    """Combos skipped by design: none (dense archs run the sliding-window
    decode variant for long_500k)."""
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every combo (of the --arch or --shape given)")
    ap.add_argument("--lower-only", action="store_true",
                    help="build the sharded arguments only (their bytes "
                    "count every leaf: no step runs to read them)")
    ap.add_argument("--opt-sharding", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank 0 on the card), meta (abstract) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                if args.arch in (None, a) and args.shape in (None, s):
                    combos.append((a, s, args.multi_pod))
    else:
        combos.append((args.arch, args.shape, args.multi_pod))

    results = []
    for arch, shape, mp in combos:
        tag = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
        try:
            r = dryrun_one(arch, shape, multi_pod=mp,
                           lower_only=args.lower_only,
                           opt_sharding=args.opt_sharding, fsdp=args.fsdp,
                           device=args.device)
            results.append(r)
            print(f"[dryrun OK ] {tag}: lower={r.get('lower_s')}s "
                  f"run={r.get('run_s')}s step_ms={r.get('step_ms')} "
                  f"args={r.get('argument_size_in_bytes')} "
                  f"bytes_per_device={r.get('bytes_per_device')} "
                  f"peak={r.get('peak_bytes')} "
                  f"coll={r.get('collective_total_bytes')} "
                  f"bottleneck={r.get('bottleneck')}", flush=True)
        except Exception as e:
            results.append({"arch": arch, "shape": shape,
                            "multi_pod": mp, "error": str(e)[:2000]})
            print(f"[dryrun ERR] {tag}: {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
            traceback.print_exc()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
