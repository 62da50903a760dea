"""h2o-danube-3-4b — dense, llama+mistral mix with SWA [arXiv:2401.16818]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    head_dim=120,
    sliding_window=4096,          # mistral-style SWA
    gated_mlp=True, act="silu", norm="rmsnorm",
    source="arXiv:2401.16818; unverified",
)
