"""qwen3-8b [hf:Qwen/Qwen3-8B].

Dense decoder: 36L, d_model=4096, 32 heads (GQA kv=8, head_dim=128),
d_ff=12288, vocab=151936, per-head q/k RMSNorm (qk_norm), no bias,
RMSNorm + SwiGLU + RoPE(1e6).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
)
