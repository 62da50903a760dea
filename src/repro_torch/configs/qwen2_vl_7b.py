"""qwen2-vl-7b — VLM backbone, M-RoPE, patch-embed vision frontend (14px
patches through the facility's CONV2D stem; 32x32 grid feeds the 1024
vision-prefix positions) [arXiv:2409.12191; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    mrope=True, mrope_sections=(16, 24, 24),   # t/h/w over head_dim/2 = 64
    vision_prefix=1024, frontend_stub=False,
    patch_size=14, image_channels=3,           # 448x448 image -> 32x32 grid
    gated_mlp=True, act="silu", norm="rmsnorm",
    source="arXiv:2409.12191; hf",
)
