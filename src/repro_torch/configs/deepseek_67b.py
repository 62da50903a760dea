"""deepseek-67b — dense llama-arch with GQA [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400,
    gated_mlp=True, act="silu", norm="rmsnorm",
    source="arXiv:2401.02954; hf",
)
