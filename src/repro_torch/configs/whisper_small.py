"""whisper-small — enc-dec audio backbone; conv frontend (two gelu conv1d
layers over 80-bin mel frames, k3s1 + k3s2) via the facility's ``conv``
op-class [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, decoder_len=448, frontend_stub=False, n_mels=80,
    gated_mlp=False, act="gelu", norm="layernorm",
    source="arXiv:2212.04356; unverified",
)
