"""mamba2-780m [arXiv:2405.21060; state-spaces/mamba2-780m card].

Attention-free SSD: 48L, d_model=1536, expand=2 (d_inner=3072),
headdim=64 (48 SSD heads), d_state=128, conv=4, vocab=50280,
tied embeddings, no FFN blocks (the mixer IS the block).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_groups=1,
    ssm_conv=4, ssm_chunk=256, tie_embeddings=True,
)
