"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    head_dim=64,                      # shared block: 32 heads on 2*d concat
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv_width=4,
    shared_attn_every=6,
    gated_mlp=True, act="gelu", norm="rmsnorm",
    source="arXiv:2411.15242; hf",
)
