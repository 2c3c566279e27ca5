"""Language-model assembly for the assigned architecture pool.

Port of the JAX package's ``models/model.py``: its training loss
(``loss_fn``), its serve path (``prefill`` and ``decode_step``) and the
full-sequence forward they share (``forward_logits``). A model is a list
of *layer groups*: maximal runs of identical layer specs. A group of n ≥ 2
layers keeps JAX's stacked parameters and caches (a leading n axis on
every leaf, so both packages' trees match leaf for leaf) and runs as a
Python loop over n where JAX runs ``lax.scan``; singleton groups are
applied directly. Heterogeneous archs (recurrentgemma's r-r-a pattern,
llama-vision's every-5th cross-attn layer) fall out of the same grouping.

Gradients come from autograd. With ``cfg.remat`` set and autograd
recording, each layer of the full-sequence forward runs under
``torch.utils.checkpoint`` (JAX wraps the layer body in
``jax.checkpoint``): its activations are recomputed in the backward
instead of kept, which changes memory, not numbers. Under
``torch.no_grad`` / ``inference_mode`` (the serve path) nothing is
recomputed.

``param_specs`` and ``cache_specs`` give JAX's partition-spec trees
(``shardctx.P``; a stacked group's specs lead with None). With parameters,
inputs and caches as DTensors laid out by them (``launch/specs.py``), the
same entry points run a sharded program under ``shardctx.dtensor_ops()``:
DTensor's ``implicit_replication`` (the plain tensors the model makes
inside a step, such as positions, RoPE angles, masks and scalars, count
as replicated) and a function mode that routes the few ops whose DTensor
rules would gather a shard whole or fail to their shard-wise forms. The
code here stays plain tensor code; only the attention core
(``attention.gqa_attend``, ``blockwise_attention``) is marked to run on
each rank's local shards.

Entry points:
  init_params(gen)                        parameters drawn from `gen`
  loss_fn(params, batch)                  training forward + CE loss
  forward_logits(params, batch)           full-sequence forward
  prefill(params, batch, caches)          fill caches, return last logits
  decode_step(params, token, caches, pos) one-token serve step

The serve entry points leave the given caches as they were and return new
ones (one copy of every cache leaf per call), as the JAX functions do; with
``donate=True`` the caller gives the caches up and each layer writes its
slot or state into them in place, as a jit with donated buffers would.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_embed, apply_mlp, apply_norm,
                                       embed_spec, init_embed, init_mlp,
                                       init_norm, make_dense, mlp_spec,
                                       norm_spec, rms_head_norm)
from repro_torch.models.shardctx import (P, constrain, is_spec,
                                         recompute_context)

MOE_AUX_COEF = 0.01


class LayerSpec(NamedTuple):
    """Shape of one decoder layer: which sequence mixer it runs, whether a
    cross-attention sublayer follows, and which FFN kind closes it."""

    mixer: str          # attn | mla | ssd | rglru | xattn
    cross: bool         # additional cross-attn sublayer (whisper decoder)
    ffn: str            # dense | moe | none
    causal: bool = True


def decoder_layer_specs(cfg: ArchConfig) -> list[LayerSpec]:
    kinds = cfg.layer_kinds()
    specs = []
    for i, kind in enumerate(kinds):
        mixer = kind
        if cfg.use_mla and kind == "attn":
            mixer = "mla"
        ffn = "none" if cfg.family == "ssm" else cfg.ffn_kind(i)
        cross = cfg.is_encdec   # whisper decoder: self + cross each layer
        specs.append(LayerSpec(mixer, cross, ffn, causal=True))
    return specs


def group_specs(specs: list[LayerSpec]) -> list[tuple[LayerSpec, int]]:
    groups: list[tuple[LayerSpec, int]] = []
    for s in specs:
        if groups and groups[-1][0] == s:
            groups[-1] = (s, groups[-1][1] + 1)
        else:
            groups.append((s, 1))
    return groups


def _stacked(n: int, one):
    """A group of n layers' trees with a leading n axis on every leaf: the
    leaves are allocated once and filled layer by layer from one(i), so the
    peak holds the group plus one layer."""
    first = one(0)
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    tree_map(lambda o, x: o[0].copy_(x), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda o, x: o[i].copy_(x), out, one(i))
    return out


def _layer(tree, i: int):
    """Layer i of a stacked group's tree (views)."""
    return tree_map(lambda x: x[i], tree)


def _layers(tree, n: int) -> list:
    """The n layers of a stacked group's tree (views), each leaf unbound
    once: under autograd the backward of ``unbind`` stacks the n layers'
    gradients into one leaf-sized tensor, where n selects ``x[i]`` would
    each allocate a zero tensor the size of the whole leaf."""
    leaves, treespec = tree_flatten(tree)
    per_leaf = [torch.unbind(x) for x in leaves]
    return [tree_unflatten([u[i] for u in per_leaf], treespec)
            for i in range(n)]


# ------------------------------------------------------------------ layers

def init_layer(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec, dtype):
    dev = gen.device
    p: dict[str, Any] = {"ln1": init_norm(dtype, cfg.d_model, cfg.norm, dev)}
    if spec.mixer == "attn":
        p["mixer"] = attn.init_attention(gen, cfg, dtype)
    elif spec.mixer == "xattn":
        p["mixer"] = attn.init_attention(gen, cfg, dtype, cross=True)
    elif spec.mixer == "mla":
        p["mixer"] = mla_mod.init_mla(gen, cfg, dtype)
    elif spec.mixer == "ssd":
        p["mixer"] = ssd_mod.init_ssd(gen, cfg, dtype)
    elif spec.mixer == "rglru":
        p["mixer"] = rglru_mod.init_rglru(gen, cfg, dtype)
    else:
        raise ValueError(spec.mixer)
    if spec.cross:
        p["lnx"] = init_norm(dtype, cfg.d_model, cfg.norm, dev)
        p["xattn"] = attn.init_attention(gen, cfg, dtype, cross=True)
    if spec.ffn != "none":
        p["ln2"] = init_norm(dtype, cfg.d_model, cfg.norm, dev)
        if spec.ffn == "moe":
            p["ffn"] = moe_mod.init_moe(gen, cfg, dtype)
        else:
            p["ffn"] = init_mlp(gen, dtype, cfg.d_model, cfg.d_ff, cfg.act,
                                bias=(cfg.norm == "layernorm"))
    return p


def layer_spec_tree(cfg: ArchConfig, spec: LayerSpec):
    p: dict[str, Any] = {"ln1": norm_spec(cfg.norm)}
    if spec.mixer in ("attn", "xattn"):
        p["mixer"] = attn.attention_spec(cfg, cross=spec.mixer == "xattn")
    elif spec.mixer == "mla":
        p["mixer"] = mla_mod.mla_spec(cfg)
    elif spec.mixer == "ssd":
        p["mixer"] = ssd_mod.ssd_spec(cfg)
    elif spec.mixer == "rglru":
        p["mixer"] = rglru_mod.rglru_spec(cfg)
    if spec.cross:
        p["lnx"] = norm_spec(cfg.norm)
        p["xattn"] = attn.attention_spec(cfg, cross=True)
    if spec.ffn != "none":
        p["ln2"] = norm_spec(cfg.norm)
        p["ffn"] = (moe_mod.moe_spec(cfg) if spec.ffn == "moe"
                    else mlp_spec(cfg.act, bias=(cfg.norm == "layernorm")))
    return p


def _stacked_spec(tree, n: int):
    """A group of n layers' spec tree: a leading None on every spec (the
    stacked layer axis is not sharded), as JAX's ``stacked`` adds one."""
    if n == 1:
        return tree
    return tree_map(lambda ps: P(None, *ps), tree, is_leaf=is_spec)


def _ffn(p, cfg: ArchConfig, spec: LayerSpec, x, moe_dropless: bool):
    """The layer's closing FFN sublayer on the residual x: (x, aux), aux
    the MoE load-balance term or None."""
    aux = None
    if spec.ffn == "none":
        return x, aux
    fh = apply_norm(p["ln2"], x, cfg.norm)
    if spec.ffn == "moe":
        f, aux = moe_mod.apply_moe(p["ffn"], cfg, fh, dropless=moe_dropless)
    else:
        f = apply_mlp(p["ffn"], fh, cfg.act)
    return x + f, aux


def apply_layer(p, cfg: ArchConfig, spec: LayerSpec, x, positions, memory,
                gated_cross: bool, moe_dropless: bool = False):
    """Full-sequence layer (train / prefill-without-cache)."""
    h = apply_norm(p["ln1"], x, cfg.norm)
    if spec.mixer == "attn":
        mix = attn.self_attention(p["mixer"], cfg, h, positions,
                                  use_rope=cfg.use_rope, causal=spec.causal)
    elif spec.mixer == "xattn":
        mix = attn.cross_attention(p["mixer"], cfg, h, memory,
                                   gated=gated_cross)
    elif spec.mixer == "mla":
        mix = mla_mod.mla_self_attention(p["mixer"], cfg, h, positions)
    elif spec.mixer == "ssd":
        mix, _ = ssd_mod.ssd_forward(p["mixer"], cfg, h)
    elif spec.mixer == "rglru":
        mix, _ = rglru_mod.rglru_forward(p["mixer"], cfg, h)
    x = x + mix
    if spec.cross:
        xh = apply_norm(p["lnx"], x, cfg.norm)
        x = x + attn.cross_attention(p["xattn"], cfg, xh, memory)
    return _ffn(p, cfg, spec, x, moe_dropless)


# ------------------------------------------------------------------ caches

def init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch, max_len, dtype,
                     device="cuda"):
    dev = resolve_device(device)
    c: dict[str, Any] = {}
    if spec.mixer == "attn":
        c["kv"] = attn.init_kv_cache(cfg, batch, max_len, dtype, dev)
    elif spec.mixer == "mla":
        c["kv"] = mla_mod.init_mla_cache(cfg, batch, max_len, dtype, dev)
    elif spec.mixer == "ssd":
        c["ssm"] = ssd_mod.init_ssd_cache(cfg, batch, dtype, dev)
    elif spec.mixer == "rglru":
        c["lru"] = rglru_mod.init_rglru_cache(cfg, batch, dtype, dev)
    if spec.mixer == "xattn" or spec.cross:
        mem_len = (cfg.num_audio_frames if cfg.is_encdec
                   else cfg.num_image_tokens)
        shape = (batch, mem_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        c["xkv"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return c


def layer_cache_spec(cfg: ArchConfig, spec: LayerSpec, shard_kv_heads: bool):
    c: dict[str, Any] = {}
    if spec.mixer == "attn":
        c["kv"] = attn.kv_cache_spec(cfg, shard_kv_heads)
    elif spec.mixer == "mla":
        c["kv"] = mla_mod.mla_cache_spec(cfg)
    elif spec.mixer == "ssd":
        c["ssm"] = ssd_mod.ssd_cache_spec(cfg)
    elif spec.mixer == "rglru":
        c["lru"] = rglru_mod.rglru_cache_spec(cfg)
    if spec.mixer == "xattn" or spec.cross:
        mem_len = (cfg.num_audio_frames if cfg.is_encdec
                   else cfg.num_image_tokens)
        if shard_kv_heads:
            xs = P("data", None, "model", None)
        elif mem_len % 16 == 0:
            xs = P("data", "model", None, None)
        else:   # memory is small (encoder frames): replicate across model
            xs = P("data", None, None, None)
        c["xkv"] = {"k": xs, "v": xs}
    return c


def _fill_xkv(p, cfg: ArchConfig, memory):
    """Precompute cross-attention K/V from memory (paper-standard serving)."""
    k = memory @ p["wk"]
    v = memory @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    kh = k.reshape(*memory.shape[:-1], cfg.num_kv_heads,
                 cfg.resolved_head_dim)
    vh = v.reshape(*memory.shape[:-1], cfg.num_kv_heads,
                 cfg.resolved_head_dim)
    return {"k": kh, "v": vh}


def _cached_cross_attention(p, cfg: ArchConfig, x, xkv, gated: bool):
    b = x.shape[0]
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, x.shape[1], cfg.num_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(p["qnorm"], q)
    scores = attn._gqa_scores(q, xkv["k"]).to(torch.float32)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = attn._gqa_out(probs, xkv["v"], cfg.num_heads)
    out = out.reshape(b, x.shape[1], -1) @ p["wo"]
    if gated:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out


def _store(cache: dict, new: dict):
    """Write a layer's new cache leaves into its cache, in place."""
    for k, v in new.items():
        cache[k].copy_(v)


def apply_layer_prefill(p, cfg: ArchConfig, spec: LayerSpec, x, positions,
                        memory, cache, gated_cross: bool):
    """Full-sequence layer that fills its cache, in place; returns x."""
    h = apply_norm(p["ln1"], x, cfg.norm)
    if spec.mixer == "attn":
        mix, _ = attn.prefill_attention(p["mixer"], cfg, h, positions,
                                        cache["kv"], use_rope=cfg.use_rope,
                                        inplace=True)
    elif spec.mixer == "mla":
        mix = mla_mod.mla_self_attention(p["mixer"], cfg, h, positions)
        c_kv, k_rope = mla_mod._latents(p["mixer"], cfg, h, positions)
        length = cache["kv"]["c_kv"].shape[1]
        attn._write_slot(cache["kv"]["c_kv"], c_kv[:, -length:], 0, True)
        attn._write_slot(cache["kv"]["k_rope"], k_rope[:, -length:], 0, True)
    elif spec.mixer == "ssd":
        mix, new = ssd_mod.ssd_forward(p["mixer"], cfg, h)
        _store(cache["ssm"], new)
    elif spec.mixer == "rglru":
        mix, new = rglru_mod.rglru_forward(p["mixer"], cfg, h)
        _store(cache["lru"], new)
    elif spec.mixer == "xattn":
        _store(cache["xkv"], _fill_xkv(p["mixer"], cfg, memory))
        mix = _cached_cross_attention(p["mixer"], cfg, h, cache["xkv"],
                                      gated_cross)
    x = x + mix
    if spec.cross:
        _store(cache["xkv"], _fill_xkv(p["xattn"], cfg, memory))
        xh = apply_norm(p["lnx"], x, cfg.norm)
        x = x + _cached_cross_attention(p["xattn"], cfg, xh, cache["xkv"],
                                        False)
    return _ffn(p, cfg, spec, x, True)[0]


def apply_layer_decode(p, cfg: ArchConfig, spec: LayerSpec, x, cache, pos: int,
                       gated_cross: bool):
    """One-token layer that updates its cache in place; returns x."""
    h = apply_norm(p["ln1"], x, cfg.norm)
    if spec.mixer == "attn":
        mix, _ = attn.decode_attention(p["mixer"], cfg, h, cache["kv"], pos,
                                       use_rope=cfg.use_rope, inplace=True)
    elif spec.mixer == "mla":
        mix, _ = mla_mod.mla_decode(p["mixer"], cfg, h, cache["kv"], pos,
                                    inplace=True)
    elif spec.mixer == "ssd":
        mix, new = ssd_mod.ssd_decode(p["mixer"], cfg, h, cache["ssm"])
        _store(cache["ssm"], new)
    elif spec.mixer == "rglru":
        mix, new = rglru_mod.rglru_decode(p["mixer"], cfg, h, cache["lru"])
        _store(cache["lru"], new)
    elif spec.mixer == "xattn":
        mix = _cached_cross_attention(p["mixer"], cfg, h, cache["xkv"],
                                      gated_cross)
    x = x + mix
    if spec.cross:
        xh = apply_norm(p["lnx"], x, cfg.norm)
        x = x + _cached_cross_attention(p["xattn"], cfg, xh, cache["xkv"],
                                        False)
    return _ffn(p, cfg, spec, x, True)[0]


# ------------------------------------------------------------------ model

@dataclasses.dataclass(frozen=True)
class LM:
    """Decoder-only / encoder-decoder LM over the assigned arch pool."""

    cfg: ArchConfig

    # ------------- construction -------------

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    @property
    def groups(self) -> list[tuple[LayerSpec, int]]:
        return group_specs(decoder_layer_specs(self.cfg))

    @property
    def encoder_groups(self) -> list[tuple[LayerSpec, int]]:
        if not self.cfg.is_encdec:
            return []
        spec = LayerSpec("attn", False, "dense", causal=False)
        return [(spec, self.cfg.encoder_layers)]

    def init_params(self, gen: torch.Generator) -> dict:
        """Parameters drawn from `gen`, on its device."""
        cfg, dtype, dev = self.cfg, self.dtype, gen.device
        params: dict[str, Any] = {
            "embed": init_embed(gen, dtype, cfg.padded_vocab, cfg.d_model),
            "final_norm": init_norm(dtype, cfg.d_model, cfg.norm, dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = {"w": make_dense(gen,
                                              (cfg.d_model, cfg.padded_vocab),
                                              dtype, scale=0.02)}

        def stack_init(spec, n):
            if n == 1:
                return init_layer(gen, cfg, spec, dtype)
            return _stacked(n, lambda i: init_layer(gen, cfg, spec, dtype))

        params["layers"] = [stack_init(spec, n) for spec, n in self.groups]
        if cfg.is_encdec:
            params["enc_layers"] = [stack_init(spec, n)
                                    for spec, n in self.encoder_groups]
            params["enc_norm"] = init_norm(dtype, cfg.d_model, cfg.norm, dev)
        return params

    def param_specs(self) -> dict:
        """The partition spec of every parameter leaf (JAX's tree)."""
        cfg = self.cfg
        specs: dict[str, Any] = {
            "embed": embed_spec(),
            "final_norm": norm_spec(cfg.norm),
        }
        if not cfg.tie_embeddings:
            specs["head"] = {"w": P(None, "model")}
        specs["layers"] = [_stacked_spec(layer_spec_tree(cfg, spec), n)
                           for spec, n in self.groups]
        if cfg.is_encdec:
            specs["enc_layers"] = [_stacked_spec(layer_spec_tree(cfg, spec), n)
                                   for spec, n in self.encoder_groups]
            specs["enc_norm"] = norm_spec(cfg.norm)
        return specs

    # ------------- embedding / memory -------------

    def _embed(self, params, tokens, positions):
        cfg = self.cfg
        x = apply_embed(params["embed"], tokens)
        x = constrain(x, "residual")
        if cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        if not cfg.use_rope:
            # computed on the fly from positions (supports decode at any pos)
            x = x + _sinusoid_at(positions, cfg.d_model).to(x.dtype)
        return x

    def _encode(self, params, memory_embed):
        """Run the (whisper) encoder over stubbed frame embeddings."""
        cfg = self.cfg
        s = memory_embed.shape[1]
        positions = torch.arange(s, device=memory_embed.device)
        pe = _sinusoid_at(positions[None], cfg.d_model)
        x = memory_embed + pe.to(memory_embed.dtype)
        for gp, (spec, n) in zip(params["enc_layers"], self.encoder_groups):
            x = self._group_forward(gp, spec, n, x, positions, None)[0]
        return apply_norm(params["enc_norm"], x, cfg.norm)

    def _memory(self, params, batch):
        cfg = self.cfg
        if cfg.is_encdec:
            return self._encode(params, batch["audio_embed"])
        if cfg.num_image_tokens:
            return batch["image_embed"]
        return None

    # ------------- grouped execution -------------

    def _group_forward(self, gp, spec, n, x, positions, memory,
                       moe_dropless=False):
        cfg = self.cfg
        gated = bool(cfg.cross_attn_every)

        def body(lp, h):
            out, a = apply_layer(lp, cfg, spec, constrain(h, "residual"),
                                 positions, memory, gated, moe_dropless)
            return constrain(out, "residual"), a

        # JAX's jax.checkpoint of the layer body; the layers draw no random
        # bits, so the recomputation needs no saved generator state
        remat = cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in ([gp] if n == 1 else _layers(gp, n)):
            if remat:
                x, a = checkpoint(body, lp, x, use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=recompute_context)
            else:
                x, a = body(lp, x)
            if a is not None:
                aux = aux + a
        return x, aux

    # ------------- public entry points -------------

    def forward_logits(self, params, batch, moe_dropless=False):
        """Full-sequence forward -> (logits, moe_aux)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        memory = self._memory(params, batch)
        x = self._embed(params, tokens, positions[None])
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for gp, (spec, n) in zip(params["layers"], self.groups):
            x, aux = self._group_forward(gp, spec, n, x, positions, memory,
                                         moe_dropless)
            aux_total = aux_total + aux
        x = apply_norm(params["final_norm"], x, cfg.norm)
        return self._logits(params, x), aux_total

    def loss_fn(self, params, batch):
        """Training forward + causal CE loss. batch: tokens, labels [+stubs].

        The mean over (B, S) of logsumexp of the f32 logits minus the
        label's logit, plus ``MOE_AUX_COEF`` times the MoE load-balance term;
        the forward routes with capacity (not dropless), as JAX's does."""
        logits, aux_total = self.forward_logits(params, batch)
        logits = logits.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          batch["labels"][..., None].to(torch.int64))[..., 0]
        loss = torch.mean(lse - ll)
        return loss + MOE_AUX_COEF * aux_total

    def _logits(self, params, x):
        if self.cfg.tie_embeddings:
            logits = x @ params["embed"]["table"].T
        else:
            logits = x @ params["head"]["w"]
        logits = constrain(logits, "logits")
        if self.cfg.padded_vocab != self.cfg.vocab_size:
            pad_mask = (torch.arange(self.cfg.padded_vocab, device=x.device)
                        < self.cfg.vocab_size)
            logits = torch.where(pad_mask, logits, -1e30)
        return logits

    # ------------- serving -------------

    def init_caches(self, batch: int, max_len: int, device="cuda"):
        dev = resolve_device(device)
        caches = []
        for spec, n in self.groups:
            one = init_layer_cache(self.cfg, spec, batch, max_len, self.dtype,
                                   dev)
            if n > 1:
                one = tree_map(lambda x: x.new_zeros((n,) + tuple(x.shape)),
                               one)
            caches.append(one)
        return caches

    def cache_specs(self, shard_kv_heads: bool) -> list:
        """The partition spec of every cache leaf (JAX's tree)."""
        return [_stacked_spec(layer_cache_spec(self.cfg, spec, shard_kv_heads),
                              n) for spec, n in self.groups]

    def _serve_groups(self, params, caches, x, layer_fn):
        """Run x through every decoder group with layer_fn(lp, spec, x, c)
        -> x, which writes layer c's cache in place (for a stacked group,
        views of its leaves)."""
        for gp, cache, (spec, n) in zip(params["layers"], caches, self.groups):
            for i in range(n):
                lp, c = (gp, cache) if n == 1 else (_layer(gp, i),
                                                    _layer(cache, i))
                x = constrain(layer_fn(lp, spec, constrain(x, "residual"), c),
                              "residual")
        return x

    def prefill(self, params, batch, caches, donate: bool = False):
        """Run the full prompt, filling caches; returns (last_logits, caches).

        The given caches are left as they were and new ones returned, as in
        JAX; with `donate` the caller gives them up and they are filled in
        place and returned (no copy: what a jit with donated buffers does).
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        memory = self._memory(params, batch)
        x = self._embed(params, tokens, positions[None])
        gated = bool(cfg.cross_attn_every)
        caches = caches if donate else tree_map(torch.clone, caches)
        x = self._serve_groups(
            params, caches, x,
            lambda lp, spec, h, c: apply_layer_prefill(
                lp, cfg, spec, h, positions, memory, c, gated))
        x = apply_norm(params["final_norm"], x, cfg.norm)
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params, token, caches, pos: int, batch_extras=None,
                    donate: bool = False):
        """One serve step: token (B,1) at absolute position `pos`; the
        caches as in `prefill` (copied once, or written in place when
        `donate`)."""
        cfg = self.cfg
        pos = int(pos)
        posv = torch.full((token.shape[0], 1), pos, device=token.device)
        x = self._embed(params, token, posv)
        gated = bool(cfg.cross_attn_every)
        caches = caches if donate else tree_map(torch.clone, caches)
        x = self._serve_groups(
            params, caches, x,
            lambda lp, spec, h, c: apply_layer_decode(lp, cfg, spec, h, c, pos,
                                                      gated))
        x = apply_norm(params["final_norm"], x, cfg.norm)
        return self._logits(params, x), caches


def _sinusoid_at(positions, dim):
    """Sinusoidal embedding evaluated at given positions: (..., S) ->
    (..., S, dim), sin and cos interleaved (even and odd channels)."""
    half = dim // 2
    f32 = torch.float32
    i = torch.arange(half, dtype=f32, device=positions.device)
    inv = 1.0 / (10000.0 ** (2 * i / dim))
    ang = positions[..., None].to(f32) * inv
    out = torch.zeros(positions.shape + (dim,), dtype=f32,
                      device=positions.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang)
    return out


# ------------------------------------------------------------------ from JAX

def _tree_from_jax(tree, device):
    """A JAX tree (dicts and lists of numpy arrays) as the port's: every
    flat dict of arrays goes through attention_params_from_jax (same
    layouts; bf16 through f32, exactly)."""
    if isinstance(tree, (list, tuple)):
        return [_tree_from_jax(t, device) for t in tree]
    arrays = {k: v for k, v in tree.items() if not isinstance(v, (dict, list,
                                                                  tuple))}
    out = attn.attention_params_from_jax(arrays, device)
    out.update({k: _tree_from_jax(v, device) for k, v in tree.items()
                if k not in arrays})
    return {k: out[k] for k in tree}


def lm_params_from_jax(np_params: dict, device="cuda") -> dict:
    """The JAX ``LM``'s parameter tree, as numpy arrays, carried into the
    port leaf for leaf (stacked groups keep their leading layer axis)."""
    return _tree_from_jax(np_params, resolve_device(device))


def lm_caches_from_jax(np_caches: list, device="cuda") -> list:
    """The JAX ``LM``'s cache list (``init_caches`` / ``prefill`` /
    ``decode_step``), as numpy arrays, carried into the port."""
    return _tree_from_jax(np_caches, resolve_device(device))

