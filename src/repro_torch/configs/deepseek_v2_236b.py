"""deepseek-v2-236b [arXiv:2405.04434].

60L, d_model=5120, 128 heads, MLA (kv_lora_rank=512, q_lora_rank=1536,
qk_nope=128, qk_rope=64, v_head=128). MoE: 2 shared + 160 routed experts,
top-6, expert d_ff=1536; first layer dense FFN (d_ff=12288). vocab=102400.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    num_experts=160, experts_per_tok=6, num_shared_experts=2,
    moe_d_ff=1536, first_dense_layers=1,
)
