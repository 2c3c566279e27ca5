"""Per-device shard shapes of every dry-run argument, from either package.

Run as a script, in a fresh process: ``python _dryrun_shards.py jax``
imports the JAX package's dry-run (which forces 512 host devices at
import) and prints, as one JSON object, the ``NamedSharding.shard_shape``
of every leaf of the step's arguments (parameters, optimizer state,
inputs, caches) for each mesh × arch × input shape × layout (default,
``--fsdp``, and ``--opt-sharding`` where it changes the config: the MoE
archs' token groups), plus ``variant_for`` and
``_active_params``; it uses ``eval_shape`` only, never ``lower`` or
``compile``. ``python _dryrun_shards.py torch`` prints the same keys from
the port: rank 0's local shapes of ``meta`` DTensors on fake process
groups of 256 and 512 ranks. A leaf whose sharded dim the shard count
does not divide is None on both sides (JAX refuses it; DTensor would
split it unevenly).
"""
import dataclasses
import json
import sys

LAYOUTS = ("default", "fsdp", "opt")
JAX_ROW = ("starcoder2-3b", "prefill_32k")     # on 16×16


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in path)


def _jax_shard(x):
    """The shard shape, or None where JAX refuses the layout (a sharded
    dim the shard count does not divide)."""
    try:
        return list(x.sharding.shard_shape(x.shape))
    except ValueError:
        return None


def _torch_shard(x):
    """Rank 0's local shape, or None where the split is uneven (DTensor
    allows it; JAX does not)."""
    from torch.distributed.tensor import Shard
    k = [1] * x.ndim
    for size, p in zip(x.device_mesh.mesh.shape, x.placements):
        if isinstance(p, Shard):
            k[p.dim] *= size
    if any(n % c for n, c in zip(x.shape, k)):
        return None
    return list(x.to_local().shape)


def _jax() -> dict:
    import repro.launch.dryrun as d    # forces 512 host devices first
    import jax
    from repro.configs import ARCH_IDS, get_arch
    from repro.launch.mesh import make_production_mesh
    from repro.models.config import INPUT_SHAPES
    from repro.models.model import LM

    out = {}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for arch in ARCH_IDS:
            for sname, shape in INPUT_SHAPES.items():
                base, variant = d.variant_for(get_arch(arch), sname)
                out[f"variant/{arch}/{sname}"] = variant
                for layout in LAYOUTS:
                    if layout == "opt" and not base.num_experts:
                        continue   # the same arguments as the default layout
                    cfg = base
                    if layout == "opt" and cfg.num_experts:
                        cfg = dataclasses.replace(
                            cfg, moe_groups=mesh.shape["data"]
                            * mesh.shape.get("pod", 1))
                    _, args = d._build_step(LM(cfg), shape, mesh,
                                            fsdp=layout == "fsdp")
                    if shape.mode == "decode":
                        args = args[:3]         # the port passes pos as int
                    leaves = jax.tree_util.tree_flatten_with_path(args)[0]
                    out[f"{int(mp)}/{arch}/{sname}/{layout}"] = {
                        _key(p): _jax_shard(x)
                        for p, x in leaves if x.sharding is not None}
        for arch in ARCH_IDS:
            out[f"active/{arch}"] = d._active_params(get_arch(arch))
    # one combo lowered and compiled: the rows that tests/_dryrun_jax_rows.py
    # writes down for the card
    r = d.dryrun_one(*JAX_ROW)
    out["jax_row"] = {k: r[k] for k in ("argument_size_in_bytes",
                                        "collective_total_bytes")}
    return out


def _torch() -> dict:
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten_with_path

    import repro_torch.launch.dryrun as d
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.launch.mesh import (fake_process_group,
                                         make_production_mesh)
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.models.model import LM

    meta = torch.device("meta")
    out = {}
    for mp in (False, True):
        with fake_process_group(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp, device_type="cpu")
            for arch in ARCH_IDS:
                for sname, shape in INPUT_SHAPES.items():
                    base, variant = d.variant_for(get_arch(arch), sname)
                    out[f"variant/{arch}/{sname}"] = variant
                    for layout in LAYOUTS:
                        if layout == "opt" and not base.num_experts:
                            continue   # the same arguments as the default layout
                        cfg = base
                        if layout == "opt" and cfg.num_experts:
                            cfg = dataclasses.replace(
                                cfg, moe_groups=mesh.size(
                                    mesh.mesh_dim_names.index("data"))
                                * (2 if mp else 1))
                        _, args = d._build_step(LM(cfg), shape, mesh,
                                                fsdp=layout == "fsdp",
                                                device=meta)
                        leaves = tree_flatten_with_path(args)[0]
                        out[f"{int(mp)}/{arch}/{sname}/{layout}"] = {
                            _key(p): _torch_shard(x)
                            for p, x in leaves if isinstance(x, DTensor)}
    for arch in ARCH_IDS:
        out[f"active/{arch}"] = d._active_params(get_arch(arch))
    return out


if __name__ == "__main__":
    print(json.dumps(_jax() if sys.argv[1] == "jax" else _torch()))
