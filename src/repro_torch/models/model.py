"""Model assembly: init / forward / prefill / decode, dense family (port of
``repro.models.model``).

The reference scans over stacked layer pytrees; here the layers are an
``nn.ModuleList`` and the scan is a Python loop.  Only the dense family
(llama lineage incl. GQA + SWA: deepseek-7b/67b, glm4-9b, h2o-danube) is
ported; the other families raise ``NotImplementedError`` naming their
ROADMAP slice.

Attention routing: forward / prefill (dense positions) dispatch through
the facility's ``attn`` op-class via ``layers.sdpa``, which the kernel
backend runs on the flash kernel; the ring-buffer decode step passes
``kv_positions``/``valid`` and stays on sdpa's chunked two-product path.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import facility
from repro_torch.models import layers as L

_LATER_FAMILIES = {
    "moe": "ROADMAP slice B1 (models/moe.py)",
    "ssm": "ROADMAP slice B3 (models/mamba2.py)",
    "hybrid": "ROADMAP slice B3 (zamba2)",
    "audio": "ROADMAP slice B2 (whisper conv stem and cross-attention)",
    "vlm": "ROADMAP slice B2 (qwen2-vl patch embed and M-RoPE)",
}


def check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet — "
            f"{_LATER_FAMILIES.get(cfg.family, 'no slice planned')}")


class DenseBlock(nn.Module):
    def __init__(self, attn_norm: L.Norm, attn: L.Attention,
                 mlp_norm: L.Norm, mlp: L.MLP):
        super().__init__()
        self.attn_norm, self.attn = attn_norm, attn
        self.mlp_norm, self.mlp = mlp_norm, mlp


class Model(nn.Module):
    """Embedding, the layer stack and the final norm of a dense decoder."""

    def __init__(self, embed: L.Embed, layers, final_norm: L.Norm):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


# ======================================================================
# Parameters
# ======================================================================

def init_params(cfg, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> Model:
    """Random weights drawn from a seeded ``torch.Generator`` on ``device``
    (default: the card; raises when CUDA is absent).  ``dtype`` is the
    storage dtype of the 2-D weights (bf16 at rest for serving); norm
    scales stay fp32.  The values are not the reference's: torch cannot
    reproduce ``jax.random`` streams (tests carry the reference's weights
    over through ``models.convert``)."""
    check_family(cfg)
    device = facility.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    embed = L.init_embed(gen, cfg, **kw)
    layers = [DenseBlock(L.init_norm(cfg, device=device),
                         L.init_attention(gen, cfg, **kw),
                         L.init_norm(cfg, device=device),
                         L.init_mlp(gen, cfg, **kw))
              for _ in range(cfg.num_layers)]
    return Model(embed, layers, L.init_norm(cfg, device=device))


# ======================================================================
# Blocks
# ======================================================================

def _apply_dense_block(bp: DenseBlock, h, cfg, *, cos_sin, causal=None,
                       kv=None, window=None, q_offset=0, kv_positions=None,
                       valid=None):
    hn = L.apply_norm(bp.attn_norm, h, cfg)
    # Residual adds ride the output-projection / w2 GEMM epilogues.
    h, kv_out = L.apply_attention(
        bp.attn, hn, cfg, cos_sin=cos_sin, kv=kv, causal=causal,
        window=window, q_offset=q_offset, kv_positions=kv_positions,
        valid=valid, residual=h)
    hn = L.apply_norm(bp.mlp_norm, h, cfg)
    h = L.apply_mlp(bp.mlp, hn, cfg, residual=h)
    return h, kv_out


def _cos_sin_for(cfg, positions):
    """positions: (B, S) absolute."""
    cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    return (cos, sin, cos, sin)


# ======================================================================
# Forward (training / prefill)
# ======================================================================

def forward(model: Model, batch, cfg, *, collect_cache: bool = False):
    """Teacher-forced forward pass.  Returns (logits, aux, cache|None);
    ``cache["kv"]`` is the (k, v) pair stacked over layers,
    (L, B, S, KVH, D) each."""
    check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = L.embed_tokens(model.embed, tokens, cfg)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos_sin = _cos_sin_for(cfg, positions)
    ks, vs = [], []
    for layer in model.layers:
        h, (k, v) = _apply_dense_block(layer, h, cfg, cos_sin=cos_sin,
                                       window=cfg.sliding_window)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    h = L.apply_norm(model.final_norm, h, cfg)
    logits = L.logits(model.embed, h, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    cache = {"kv": (torch.stack(ks), torch.stack(vs))} if collect_cache \
        else None
    return logits, aux, cache


def prefill(model: Model, batch, cfg):
    """Process a full prompt, return last-position logits and the cache
    built by ``forward(collect_cache=True)``."""
    logits, _, caches = forward(model, batch, cfg, collect_cache=True)
    return logits[:, -1], caches


# ======================================================================
# KV cache + decode
# ======================================================================

def cache_len(cfg, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg, batch: int, seq_len: int, *, device=None,
               dtype: torch.dtype = torch.bfloat16):
    """Zero ring cache for decode at context length ``seq_len``: k and v
    (L, B, clen, KVH, D), the slot positions ``pos`` (clen,) (-1 = empty)
    and the host-side step counter ``cur``."""
    check_family(cfg)
    device = facility.resolve_device(device)
    clen = cache_len(cfg, seq_len)
    kv_shape = (cfg.num_layers, batch, clen, cfg.num_kv_heads, cfg.head_dim)
    return {"cur": 0,
            "k": torch.zeros(kv_shape, dtype=dtype, device=device),
            "v": torch.zeros(kv_shape, dtype=dtype, device=device),
            "pos": torch.full((clen,), -1, dtype=torch.int32, device=device)}


def decode_step(model: Model, cache, tokens, cfg):
    """One token for every sequence in the batch.  tokens (B, 1).

    Returns (logits (B, 1, V), new_cache).  The new token's k/v are
    written into the ring slot ``cur % clen`` of ``cache["k"]`` and
    ``cache["v"]`` IN PLACE (the cache is the largest state of a serving
    run, and copying it per token would double its traffic); the returned
    dict shares those tensors and carries the advanced ``pos``/``cur``.
    """
    check_family(cfg)
    cur = cache["cur"]
    b = tokens.shape[0]
    h = L.embed_tokens(model.embed, tokens, cfg)
    pos_b = torch.full((b, 1), cur, dtype=torch.int32, device=tokens.device)
    cos_sin = _cos_sin_for(cfg, pos_b)
    clen = cache["pos"].shape[0]
    slot = cur % clen
    kv_positions = cache["pos"].clone()
    kv_positions[slot] = cur
    kv_positions = kv_positions[None]                 # (1, clen)
    valid = kv_positions >= 0
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    for i, layer in enumerate(model.layers):
        hn = L.apply_norm(layer.attn_norm, h, cfg)
        # project the new kv and insert it into the ring
        knew = facility.contract(facility.DOT, hn,
                                 layer.attn.wk.to(hn.dtype)).reshape(
                                     b, 1, nkv, hd)
        vnew = facility.contract(facility.DOT, hn,
                                 layer.attn.wv.to(hn.dtype)).reshape(
                                     b, 1, nkv, hd)
        knew = L.apply_rope(knew, cos_sin[2], cos_sin[3])
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c[:, slot] = knew[:, 0].to(k_c.dtype)
        v_c[:, slot] = vnew[:, 0].to(v_c.dtype)
        h, _ = _apply_dense_block(
            layer, h, cfg, cos_sin=cos_sin, kv=(k_c, v_c),
            window=cfg.sliding_window, q_offset=cur,
            kv_positions=kv_positions, valid=valid)
    h = L.apply_norm(model.final_norm, h, cfg)
    logits = L.logits(model.embed, h, cfg)
    new_cache = dict(cache, pos=kv_positions[0], cur=cur + 1)
    return logits, new_cache
