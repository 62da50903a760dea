"""Architecture configuration schema + registry.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
``repro``); tests/test_torch_configs.py holds it equal, field by field.
One ``ArchConfig`` instance per assigned architecture lives in
``repro_torch/configs/<id>.py``; ``registry.get(name)`` resolves them.  The
``reduced()`` helper derives the CPU smoke-test configuration (same family,
same code paths, tiny dimensions).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0            # 0 -> = num_heads (MHA)
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention flavor ---
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # SWA window; None = full attention
    mrope: bool = False                    # qwen2-vl 3-section M-RoPE
    mrope_sections: tuple[int, ...] = (16, 24, 24)  # t/h/w halves of head_dim
    causal: bool = True

    # --- FFN ---
    gated_mlp: bool = True           # SwiGLU-style (llama lineage)
    act: str = "silu"                # silu | gelu

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden (fine-grained MoE)
    num_shared_experts: int = 0      # deepseek-moe shared experts
    first_dense_layers: int = 0      # leading dense layers before MoE
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0               # d_state; 0 -> no SSM
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256             # SSD chunk length

    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0       # apply shared attention block every N

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0          # >0 -> enc-dec model
    decoder_len: int = 448           # fixed decoder length for training
    frontend_stub: bool = False      # audio/vision embeddings precomputed
    n_mels: int = 0                  # audio frontend: mel bins per frame
                                     # (conv stem: k3s1 + k3s2, gelu, SAME)

    # --- vlm ---
    vision_prefix: int = 0           # leading positions fed by patch embeds
    patch_size: int = 0              # vision stem: square patch edge (the
                                     # CONV2D stem runs kernel=stride=patch)
    image_channels: int = 3          # vision stem input channels

    # --- norm / embeddings ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- source provenance (from the assignment table) ---
    source: str = ""

    def __post_init__(self):
        if self.num_kv_heads == 0 and self.num_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def encoder_len(self, seq: int) -> int:
        """Encoder positions per ``seq`` input frames: the conv stem's
        stride-2 second layer halves the frame axis (SAME padding); the
        stub frontend passes embeddings through unchanged."""
        if self.frontend_stub or not self.is_enc_dec:
            return seq
        return -(-seq // 2)

    def vision_grid(self) -> tuple[int, int]:
        """(rows, cols) patch grid covering ``vision_prefix`` positions —
        the nearest-square factorization, so 1024 -> 32x32 and the reduced
        config's 8 -> 2x4.  Images into the patch-embed stem are
        (B, rows * patch_size, cols * patch_size, image_channels)."""
        vp = self.vision_prefix
        gh = max(1, int(vp ** 0.5))
        while vp % gh:
            gh -= 1
        return gh, vp // gh

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists: SSM state, hybrid, or bounded SWA."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D model FLOPs)."""
        d, v = self.d_model, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2)
        n_layer_attn = d * (self.num_heads * self.head_dim
                            + 2 * self.num_kv_heads * self.head_dim
                            + self.num_heads * self.head_dim)
        def ffn(dff):
            return d * dff * (3 if self.gated_mlp else 2)
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_headdim
            per = (d * (2 * d_in + 2 * self.ssm_state + nh)  # in_proj etc.
                   + d_in * d                                 # out_proj
                   + self.ssm_conv_width * (d_in + 2 * self.ssm_state))
            return n + self.num_layers * (per + d)
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_headdim
            per = (d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d
                   + self.ssm_conv_width * (d_in + 2 * self.ssm_state)
                   + 2 * d)                        # mamba block + norms
            n += self.num_layers * per
            # one shared transformer block (params counted once):
            # concat down-proj + attention + MLP
            hd = self.head_dim
            n_shared = (2 * d * d
                        + d * hd * (2 * self.num_heads
                                    + 2 * self.num_kv_heads)
                        + ffn(self.d_ff))
            return n + n_shared
        per = n_layer_attn + 2 * d
        if self.is_moe:
            moe_layers = self.num_layers - self.first_dense_layers
            experts = self.num_experts + self.num_shared_experts
            per_moe = (experts * ffn(self.moe_d_ff or self.d_ff)
                       + d * self.num_experts)  # router
            n += (self.first_dense_layers * (per + ffn(self.d_ff))
                  + moe_layers * (per + per_moe))
        else:
            n += self.num_layers * (per + ffn(self.d_ff))
        if self.is_enc_dec:
            # encoder layers + cross attention in decoder
            n += self.encoder_layers * (n_layer_attn + ffn(self.d_ff) + 2 * d)
            n += self.num_layers * n_layer_attn  # cross-attn
            if not self.frontend_stub:
                # conv stem: k3 (n_mels -> d) + k3 s2 (d -> d), with biases
                n += 3 * self.n_mels * d + d + 3 * d * d + d
        if self.vision_prefix:
            n += d * d                       # vision_proj
            if not self.frontend_stub and self.patch_size:
                # patch-embed stem: (ps, ps, C) -> d conv, with bias
                n += self.patch_size ** 2 * self.image_channels * d + d
        return n

    def active_param_count(self) -> int:
        """Params touched per token: MoE counts only routed top-k experts;
        hybrid counts the shared block once per group it is applied to."""
        if self.family == "hybrid" and self.shared_attn_every:
            d, hd = self.d_model, self.head_dim
            n_shared = (2 * d * d
                        + d * hd * (2 * self.num_heads
                                    + 2 * self.num_kv_heads)
                        + d * self.d_ff * (3 if self.gated_mlp else 2))
            n_groups = -(-self.num_layers // self.shared_attn_every)
            return self.param_count() + (n_groups - 1) * n_shared
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        def ffn(dff):
            return d * dff * (3 if self.gated_mlp else 2)
        full = self.param_count()
        moe_layers = self.num_layers - self.first_dense_layers
        inactive = moe_layers * (self.num_experts - self.top_k) * ffn(
            self.moe_d_ff or self.d_ff)
        return full - inactive


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads * 4 // max(cfg.num_heads, 1), 4)),
        head_dim=32,
        d_ff=256,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 8),
        top_k=min(cfg.top_k, 2),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        first_dense_layers=min(cfg.first_dense_layers, 1),
        sliding_window=64 if cfg.sliding_window else None,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else 64,
        ssm_chunk=16,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        decoder_len=16 if cfg.is_enc_dec else cfg.decoder_len,
        vision_prefix=8 if cfg.vision_prefix else 0,
        patch_size=4 if cfg.patch_size else 0,
        mrope_sections=(4, 6, 6) if cfg.mrope else cfg.mrope_sections,
    )
