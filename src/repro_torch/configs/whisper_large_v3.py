"""whisper-large-v3 [arXiv:2212.04356, openai/whisper-large-v3 card].

Enc-dec audio transformer backbone: 32 encoder + 32 decoder layers,
d_model=1280, 20 heads (kv=20, i.e. MHA), d_ff=5120, vocab=51866,
LayerNorm + GELU, sinusoidal positions (no RoPE), qkv bias.
The mel-spectrogram + conv2 frontend is STUBBED: `input_specs()` feeds
precomputed frame embeddings (B, 1500, 1280).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    qkv_bias=True, norm="layernorm", act="gelu", use_rope=False,
    tie_embeddings=True,
    encoder_layers=32, num_audio_frames=1500,
)
