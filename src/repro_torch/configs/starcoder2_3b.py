"""starcoder2-3b [arXiv:2402.19173].

Dense decoder: 30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288,
vocab=49152, LayerNorm + GELU + bias, RoPE, native sliding window 4096
— the one assigned dense arch whose *published* config is sub-quadratic,
so `long_500k` runs in its native configuration.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    qkv_bias=True, norm="layernorm", act="gelu",
    sliding_window=4096, rope_theta=999999.4,
)
