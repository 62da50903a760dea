"""deepseek-moe-16b — fine-grained MoE: 64 routed top-6 + 2 shared experts,
first layer dense [arXiv:2401.06066; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944,                      # dense first-layer FFN
    moe_d_ff=1408,                   # fine-grained expert hidden
    vocab_size=102400,
    num_experts=64, top_k=6, num_shared_experts=2, first_dense_layers=1,
    gated_mlp=True, act="silu", norm="rmsnorm",
    source="arXiv:2401.06066; hf",
)
