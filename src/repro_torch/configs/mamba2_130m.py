"""mamba2-130m — attention-free SSD (state-space duality)
[arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv_width=4,
    gated_mlp=False, norm="rmsnorm",
    source="arXiv:2405.21060; unverified",
)
