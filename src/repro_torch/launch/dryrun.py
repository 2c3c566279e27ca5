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
                  counts the collectives and reckons bytes (the
                  counterpart of lower + compile)
  --device cuda   the card (the default): rank 0's local program at its
                  true production shapes, with the card's peak memory and
                  step time measured. The collectives move nothing, so the
                  values computed mean nothing.

The step runs under ``shardctx.dtensor_ops()``: DTensor's
``implicit_replication`` (the plain tensors the model makes inside the
step, such as positions, masks and scalars, count as replicated) and the
shard-wise forms of the embedding lookup, the vocab projection, the loss
and the attention core. DTensor's sharding propagation chooses every
other op's layout and collectives, where JAX lets GSPMD choose. The
abstract mode's mesh is of cpu device type (its tensors are on meta), on
which DTensor would move a shard to another dim by an all-gather, as gloo
has no all-to-all; the dry-run has it issue the card's all-to-all there
too, so the two modes count the same collectives. XLA's memory and cost
analysis have no counterpart: the keys ``temp_size_in_bytes``,
``hlo_*``, ``compile_s`` and ``collective_bytes_tpu_wire`` are not
produced; the card mode measures ``peak_bytes`` and ``step_ms`` instead.

Importing this module starts no process group.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --device meta --out dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time
import traceback

import torch
from torch.distributed.tensor import DTensor
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


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in `tree`."""
    total = 0
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            loc = x.to_local() if isinstance(x, DTensor) else x
            total += loc.numel() * loc.element_size()
    return total


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
            with dtensor_ops(cfg.padded_vocab), CollectiveCounter() as cc:
                out = fn(*args)
            synchronize(dev)
            result["run_s"] = round(time.perf_counter() - t1, 1)
            result["output_size_in_bytes"] = local_bytes(out)
            del out
            if dev.type != "meta":
                with dtensor_ops(cfg.padded_vocab):
                    result.update(measure(lambda: fn(*args), dev, steps))
                result["bytes_per_device"] = result["peak_bytes"]
    # every collective that ran was counted (no loop body counted once)
    result["while_mult"] = 1
    result["collective_counts_per_device"] = cc.counts
    result["collective_bytes_per_device"] = cc.bytes
    result["collective_total_bytes"] = int(sum(cc.bytes.values()))
    result.update(_roofline(cfg, shape, chips, result["collective_total_bytes"]))
    return result


def measure(step, dev: torch.device, steps: int) -> dict:
    """Median wall time of `steps` calls of step() (each ended by a device
    sync) and, on the card, the peak memory over them."""
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
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev))
            if cuda else None}


def _roofline(cfg, shape, chips: int, coll_bytes: int) -> dict:
    """Analytic FLOPs and HBM bytes per device and the roofline terms on
    the H100 constants (`launch.mesh`), with JAX's keys."""
    ac = analytic_cost(cfg, shape)
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
    model_flops = (6 if shape.mode == "train" else 2) * _active_params(cfg) \
        * tokens
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


def skip_reason(arch_id: str, shape_name: str) -> str | None:
    """Combos skipped by design: none (dense archs run the sliding-window
    decode variant for long_500k)."""
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--lower-only", action="store_true",
                    help="build the sharded arguments only")
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
