"""deepseek-7b — dense llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400,
    gated_mlp=True, act="silu", norm="rmsnorm",
    source="arXiv:2401.02954; hf",
)
