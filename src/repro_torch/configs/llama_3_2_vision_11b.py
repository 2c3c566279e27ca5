"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision].

VLM language backbone: 40L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=128256; a gated cross-attention layer every 5th layer (8 total)
attending to projected vision tokens. The ViT encoder + projector is
STUBBED: `input_specs()` feeds projected patch embeddings (B, 1600, 4096).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5, num_image_tokens=1600,
)
