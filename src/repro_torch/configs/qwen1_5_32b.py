"""qwen1.5-32b [hf:Qwen/Qwen1.5-32B; arch per hf:Qwen/Qwen1.5-0.5B family].

Dense decoder: 64L, d_model=5120, 40 heads (kv=40 -> MHA), d_ff=27392,
vocab=152064, RMSNorm + SwiGLU + RoPE, QKV bias (the Qwen1.5 signature).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
)
