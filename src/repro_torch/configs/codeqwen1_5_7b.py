"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B].

Qwen1.5 architecture: 32L, d_model=4096, 32 heads (kv=32), d_ff=13440,
vocab=92416, QKV bias, RMSNorm + SwiGLU + RoPE.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    qkv_bias=True, rope_theta=1_000_000.0,
)
