"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

MoE decoder: 24L, d_model=1024, 16 heads (GQA kv=8), 32 experts top-8,
expert d_ff=512, vocab=49155. RMSNorm + SwiGLU + RoPE, tied embeddings.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=32, experts_per_tok=8, moe_d_ff=512,
    tie_embeddings=True, rope_theta=10000.0,
)
