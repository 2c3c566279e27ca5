"""Architecture configuration for the assigned model pool.

A copy of the JAX package's ``models/config.py`` (which imports only
``dataclasses``), so the port imports nothing of that package. Every field
maps to a published spec; the per-arch instantiations (with citations)
live in ``repro_torch/configs/<id>.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Static architecture description of one assigned transformer/SSM/MoE
    model family — every structural knob the LM builder consumes, with
    `reduced()` producing the small-config variant the tests train."""

    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio

    num_layers: int = 12
    d_model: int = 1024
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 4096
    vocab_size: int = 32000

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False            # per-head RMSNorm on q,k (qwen3)
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full attention
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu | geglu
    tie_embeddings: bool = False
    use_rope: bool = True            # whisper: sinusoidal/learned instead
    scale_embed: bool = False        # gemma-style sqrt(d_model) embed scale

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # expert hidden (d_ff of each expert)
    first_dense_layers: int = 0      # deepseek: first k layers use dense FFN
    capacity_factor: float = 1.25
    moe_groups: int = 1              # >1: route within token groups (device-
                                     # local capacity, GShard-style) — keeps
                                     # the dispatch gather shard-local

    # MLA (deepseek-v2)
    use_mla: bool = False
    q_lora_rank: int = 0             # 0 = full-rank q projection
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (recurrentgemma)
    pattern: tuple[str, ...] = ()    # repeating unit of mixer kinds, e.g.
                                     # ("rglru","rglru","attn"); empty = homogeneous
    lru_width: int = 0
    conv1d_width: int = 4

    # VLM (llama-3.2-vision)
    cross_attn_every: int = 0        # a cross-attn layer every k-th layer
    num_image_tokens: int = 0

    # enc-dec (whisper)
    encoder_layers: int = 0
    num_audio_frames: int = 0        # encoder sequence (stubbed embeddings)

    # numerics
    dtype: str = "bfloat16"
    remat: bool = True

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/logit rows padded so 16-way tensor sharding divides
        evenly (Megatron-style padded vocab). Padded logits are masked."""
        mult = 2048 if self.vocab_size >= 2048 else 128
        return -(-self.vocab_size // mult) * mult

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_kinds(self) -> list[str]:
        """Mixer kind per decoder layer."""
        n = self.num_layers
        if self.family == "ssm":
            return ["ssd"] * n
        if self.pattern:
            out = [self.pattern[i % len(self.pattern)] for i in range(n)]
            return out
        if self.cross_attn_every:
            # llama-3.2-vision: cross-attention every k-th layer (layer
            # indices k-1, 2k-1, ...)
            return ["xattn" if (i + 1) % self.cross_attn_every == 0 else "attn"
                    for i in range(n)]
        return ["attn"] * n

    def ffn_kind(self, layer_idx: int) -> str:
        if self.num_experts and layer_idx >= self.first_dense_layers:
            return "moe"
        return "dense"

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: tiny dims, same family/kinds."""
        kw = dict(
            num_layers=min(self.num_layers, len(self.pattern) or 2)
            if self.pattern else 2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=max(1, min(self.num_kv_heads,
                                    min(self.num_heads, 4) // 2)),
            head_dim=32,
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            dtype="float32", remat=False,
        )
        if self.pattern:
            kw["num_layers"] = len(self.pattern)
        if self.num_experts:
            kw.update(num_experts=4, experts_per_tok=2,
                      num_shared_experts=min(self.num_shared_experts, 1),
                      moe_d_ff=64, first_dense_layers=min(self.first_dense_layers, 1))
        if self.use_mla:
            kw.update(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=32,
                      qk_rope_dim=16, v_head_dim=32)
        if self.family == "ssm":
            kw.update(d_model=128, ssm_state=16, ssm_headdim=32, ssm_chunk=8)
        if self.lru_width:
            kw["lru_width"] = kw["d_model"]
        if self.cross_attn_every:
            kw.update(num_layers=self.cross_attn_every,
                      num_image_tokens=8)
        if self.encoder_layers:
            kw.update(encoder_layers=2, num_audio_frames=12)
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One named workload shape (sequence length, global batch, and
    train/prefill/decode mode) from the INPUT_SHAPES registry."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
