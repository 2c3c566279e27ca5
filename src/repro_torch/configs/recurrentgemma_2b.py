"""recurrentgemma-2b [arXiv:2402.19427].

Hybrid Griffin architecture: 26L, d_model=2560, pattern 2 recurrent
(RG-LRU, lru_width=2560) : 1 local attention (10 heads, MQA kv=1,
window=2048), d_ff=7680 GeGLU, vocab=256000, tied embeddings,
sqrt(d_model) embedding scale.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    head_dim=256, d_ff=7680, vocab_size=256000,
    act="geglu", sliding_window=2048, tie_embeddings=True,
    scale_embed=True,
    pattern=("rglru", "rglru", "attn"), lru_width=2560, conv1d_width=4,
)
