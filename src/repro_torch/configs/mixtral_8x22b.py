"""mixtral-8x22b — 8 experts top-2, GQA, SWA [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, moe_d_ff=16384, vocab_size=32768,
    num_experts=8, top_k=2,
    sliding_window=4096,
    gated_mlp=True, act="silu", norm="rmsnorm",
    source="arXiv:2401.04088; hf",
)
