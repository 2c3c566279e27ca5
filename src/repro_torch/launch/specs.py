"""Sharded parameters, inputs and caches for the dry-run: DTensors with the
placements of JAX's spec trees, on ``meta`` (no allocation: the
counterpart of JAX's ``ShapeDtypeStruct`` with a ``NamedSharding``) or on
a device, where each rank holds only its own shard.

Port of the JAX package's ``repro.launch.specs``. A tree's shapes and
dtypes come from the model's own init or cache constructor run on
``meta``; `with_sharding` gives every leaf its spec's placements on the
mesh and makes this rank's local shard.
"""
from __future__ import annotations


import torch
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._pytree import tree_map

from repro_torch.analysis.cost import meta_param_tree
from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.models.model import LM
from repro_torch.models.shardctx import P, from_local, is_spec, placements


def batch_axes(mesh) -> tuple:
    """Data-parallel axes: ('pod','data') on the multi-pod mesh."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def adapt_spec(ps: P, mesh) -> P:
    """Map 'data' -> ('pod','data') on multi-pod meshes."""
    if "pod" not in mesh.mesh_dim_names:
        return ps
    return P(*[("pod", "data") if e == "data" else e for e in ps])


def _placed(spec: P, mesh) -> tuple:
    return placements(adapt_spec(spec, mesh), mesh)


def sharded(shape, dtype, spec: P, mesh, device="cuda", fill=None):
    """A DTensor of global `shape` and `dtype` laid out as `spec` on
    `mesh`, whose local shard (DTensor's split: the first shards take
    ceil(n / k) rows) is made on `device`, uninitialised, or filled in
    place by `fill(local)`."""
    pl = _placed(spec, mesh)
    size = compute_local_shape_and_global_offset(tuple(shape), mesh, pl)[0]
    local = torch.empty(size, dtype=dtype, device=device)
    if fill is not None and local.device.type != "meta":
        fill(local)
    return from_local(local, mesh, pl, shape)


def with_sharding(tree, tree_spec, mesh, device="cuda", fill=None):
    """Every tensor of `tree` (any device; only shapes and dtypes are read)
    as a DTensor with its spec's placements (`sharded`), in `tree`'s own
    structure and order; `tree_spec` mirrors it with a spec per tensor."""
    return tree_map(lambda x, spec: sharded(x.shape, x.dtype, spec, mesh,
                                            device, fill), tree, tree_spec)


def fill_normal(seed: int):
    """A `fill` drawing N(0, 0.02²) (a finite, small stand-in for trained
    weights: the dry-run's values carry no meaning)."""
    gens: dict = {}

    def fill(x):
        if x.device not in gens:
            gens[x.device] = torch.Generator(x.device).manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=gens[x.device],
                            device=x.device) * 0.02)
    return fill


def meta_params(lm: LM) -> dict:
    """The parameter tree's shapes and dtypes, on ``meta`` (drawn once per
    config; the tree is only read)."""
    return meta_param_tree(lm.cfg)


def abstract_params(lm: LM, mesh, device="cuda", seed: int = 0):
    """The parameters, sharded by ``lm.param_specs()``; on a device each
    local shard is drawn from N(0, 0.02²)."""
    return with_sharding(meta_params(lm), lm.param_specs(), mesh, device,
                         fill_normal(seed))


def input_specs(cfg: ArchConfig, shape: InputShape, mesh, device="cuda",
                seed: int = 0, batch_axis=None) -> dict:
    """Model inputs for the given input shape, sharded: the batch dim over
    `batch_axis` if given, else over the data axes when the batch has more
    than one row. Tokens are drawn uniformly from the vocabulary,
    embeddings from N(0, 0.02²)."""
    b = shape.global_batch
    bspec = batch_axis or (batch_axes(mesh) if b > 1 else None)
    dt = getattr(torch, cfg.dtype)
    gen = None

    def tokens(x):
        nonlocal gen
        gen = gen or torch.Generator(x.device).manual_seed(seed)
        x.copy_(torch.randint(0, cfg.vocab_size, x.shape, generator=gen,
                              device=x.device))
    seq = shape.seq_len if shape.mode != "decode" else 1
    tok = sharded((b, seq), torch.int32, P(bspec, None), mesh, device, tokens)
    batch = {"tokens": tok}
    if shape.mode != "decode":
        # a tensor of its own: a step may read one and not the other
        batch["labels"] = sharded((b, seq), torch.int32, P(bspec, None),
                                  mesh, device, tokens)
    emb = fill_normal(seed + 1)
    if cfg.is_encdec:
        batch["audio_embed"] = sharded(
            (b, cfg.num_audio_frames, cfg.d_model), dt,
            P(bspec, None, None), mesh, device, emb)
    if cfg.num_image_tokens:
        batch["image_embed"] = sharded(
            (b, cfg.num_image_tokens, cfg.d_model), dt,
            P(bspec, None, None), mesh, device, emb)
    return batch


def cache_specs_for(lm: LM, shape: InputShape, mesh) -> list:
    """``lm.cache_specs`` for this mesh and shape: kv heads sharded over
    'model' when they divide it; at batch 1 'data' stripped everywhere
    ('data' only ever marks the batch dim in cache specs)."""
    cfg = lm.cfg
    model_size = mesh.size(mesh.mesh_dim_names.index("model"))
    shard_kv = (cfg.num_kv_heads % model_size == 0
                and cfg.num_kv_heads >= model_size)
    specs = lm.cache_specs(shard_kv)
    if shape.global_batch == 1:
        specs = tree_map(lambda ps: P(*[None if e == "data" else e
                                        for e in ps]), specs, is_leaf=is_spec)
    return specs


def abstract_caches(lm: LM, shape: InputShape, mesh, device="cuda"):
    """Zero caches for `shape`, sharded by `cache_specs_for`."""
    caches = lm.init_caches(shape.global_batch, shape.seq_len, device="meta")
    return with_sharding(caches, cache_specs_for(lm, shape, mesh), mesh,
                         device, torch.Tensor.zero_)
