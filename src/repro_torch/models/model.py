"""Model assembly: init / forward / prefill / decode (port of
``repro.models.model``).

The reference scans over stacked layer pytrees; here the layers are an
``nn.ModuleList`` and the scan is a Python loop.  Ported families: dense
(llama lineage incl. GQA + SWA: deepseek-7b/67b, glm4-9b, h2o-danube), ssm
(mamba2) and hybrid (zamba2: mamba2 groups with one shared attention block
applied after every ``shared_attn_every`` layers, on concat(h, embedding)).
moe, audio and vlm raise ``NotImplementedError`` naming their ROADMAP slice.

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
from repro_torch.models import mamba2 as M2

_LATER_FAMILIES = {
    "moe": "ROADMAP slice B1 (models/moe.py)",
    "audio": "ROADMAP slice B2 (whisper conv stem and cross-attention)",
    "vlm": "ROADMAP slice B2 (qwen2-vl patch embed and M-RoPE)",
}
_FAMILIES = ("dense", "ssm", "hybrid")


def check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet — "
            f"{_LATER_FAMILIES.get(cfg.family, 'no slice planned')}")


class DenseBlock(nn.Module):
    def __init__(self, attn_norm: L.Norm, attn: L.Attention,
                 mlp_norm: L.Norm, mlp: L.MLP):
        super().__init__()
        self.attn_norm, self.attn = attn_norm, attn
        self.mlp_norm, self.mlp = mlp_norm, mlp


class SSMBlock(nn.Module):
    def __init__(self, norm: L.Norm, mamba: M2.Mamba2):
        super().__init__()
        self.norm, self.mamba = norm, mamba


class SharedAttn(nn.Module):
    """zamba2's one shared transformer block: ``in_proj`` (2d, d) maps
    concat(h, embedding) back to d, then attention and MLP."""

    def __init__(self, in_proj, attn_norm: L.Norm, attn: L.Attention,
                 mlp_norm: L.Norm, mlp: L.MLP):
        super().__init__()
        self.in_proj = L._param(in_proj)
        self.attn_norm, self.attn = attn_norm, attn
        self.mlp_norm, self.mlp = mlp_norm, mlp


class Model(nn.Module):
    """Embedding, the layer stack (``DenseBlock``s or ``SSMBlock``s), the
    hybrid family's shared attention block, and the final norm."""

    def __init__(self, embed: L.Embed, layers, final_norm: L.Norm,
                 shared_attn: SharedAttn | None = None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.shared_attn = shared_attn


# ======================================================================
# Parameters
# ======================================================================

def init_params(cfg, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> Model:
    """Random weights drawn from a seeded ``torch.Generator`` on ``device``
    (default: the card; raises when CUDA is absent).  ``dtype`` is the
    storage dtype of the projection weights (bf16 at rest for serving);
    norm scales, the SSM's 1-D parameters and its conv taps stay fp32.
    The values are not the reference's: torch cannot reproduce
    ``jax.random`` streams (tests carry the reference's weights over
    through ``models.convert``)."""
    check_family(cfg)
    device = facility.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    embed = L.init_embed(gen, cfg, **kw)
    if cfg.family == "dense":
        layers = [DenseBlock(L.init_norm(cfg, device=device),
                             L.init_attention(gen, cfg, **kw),
                             L.init_norm(cfg, device=device),
                             L.init_mlp(gen, cfg, **kw))
                  for _ in range(cfg.num_layers)]
    else:
        layers = [SSMBlock(L.init_norm(cfg, device=device),
                           M2.init_mamba2(gen, cfg, **kw))
                  for _ in range(cfg.num_layers)]
    shared = None
    if cfg.shared_attn_every:
        shared = SharedAttn(
            L._dense_init(gen, (2 * cfg.d_model, cfg.d_model), **kw),
            L.init_norm(cfg, device=device), L.init_attention(gen, cfg, **kw),
            L.init_norm(cfg, device=device), L.init_mlp(gen, cfg, **kw))
    return Model(embed, layers, L.init_norm(cfg, device=device), shared)


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


def _apply_ssm_block(bp: SSMBlock, h, cfg, state=None):
    hn = L.apply_norm(bp.norm, h, cfg)
    out, new_state = M2.apply_mamba2(bp.mamba, hn, cfg, state=state)
    return h + out, new_state


def _apply_shared_attn(sp: SharedAttn, h, emb0, cfg, *, cos_sin, ring=None,
                       **attn_kw):
    """zamba2's shared block on concat(h, original embedding).  In decode,
    ``ring`` is (k cache, v cache, slot): the new token's k/v go into the
    ring first and attention reads the whole ring (``attn_kw`` carries its
    positions)."""
    hin = facility.contract(facility.DOT, torch.cat([h, emb0], dim=-1),
                            sp.in_proj)
    hn = L.apply_norm(sp.attn_norm, hin, cfg)
    kv = None
    if ring is not None:
        k_c, v_c, slot = ring
        _ring_insert(sp.attn, hn, k_c, v_c, slot, cos_sin, cfg,
                     cast_weights=False)
        kv = (k_c, v_c)
    a, _ = L.apply_attention(sp.attn, hn, cfg, cos_sin=cos_sin, kv=kv,
                             **attn_kw)
    hin = hin + a
    m = L.apply_mlp(sp.mlp, L.apply_norm(sp.mlp_norm, hin, cfg), cfg)
    return h + hin + m


def _groups(cfg):
    """zamba2's layer groups: ``shared_attn_every`` mamba2 layers (the last
    group may be shorter), each followed by the shared block."""
    every, n = cfg.shared_attn_every, cfg.num_layers
    return [range(s, min(s + every, n)) for s in range(0, n, every)]


def _cos_sin_for(cfg, positions):
    """positions: (B, S) absolute."""
    cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    return (cos, sin, cos, sin)


# ======================================================================
# Forward (training / prefill)
# ======================================================================

def forward(model: Model, batch, cfg, *, collect_cache: bool = False):
    """Teacher-forced forward pass.  Returns (logits, aux, cache|None).
    The cache, as the reference's: dense, ``cache["kv"]``, the (k, v)
    pair stacked over layers, (L, B, S, KVH, D) each; ssm, ``"ssm"``
    (L, B, H, N, P) fp32 and ``"conv"`` (L, B, W-1, conv_dim); hybrid,
    nothing (its shared block's cache is not collected)."""
    check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = L.embed_tokens(model.embed, tokens, cfg)
    emb0 = h
    cos_sin = None
    if cfg.family != "ssm":
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        cos_sin = _cos_sin_for(cfg, positions)
    cache = {}
    if cfg.family == "dense":
        ks, vs = [], []
        for layer in model.layers:
            h, (k, v) = _apply_dense_block(layer, h, cfg, cos_sin=cos_sin,
                                           window=cfg.sliding_window)
            if collect_cache:
                ks.append(k)
                vs.append(v)
        if collect_cache:
            cache["kv"] = (torch.stack(ks), torch.stack(vs))
    elif cfg.family == "ssm":
        states = []
        for layer in model.layers:
            h, st = _apply_ssm_block(layer, h, cfg)
            if collect_cache:
                states.append(st)
        if collect_cache:
            cache["ssm"] = torch.stack([st["ssm"] for st in states])
            cache["conv"] = torch.stack([st["conv"] for st in states])
    else:
        for group in _groups(cfg):
            for i in group:
                h, _ = _apply_ssm_block(model.layers[i], h, cfg)
            h = _apply_shared_attn(model.shared_attn, h, emb0, cfg,
                                   cos_sin=cos_sin)
    h = L.apply_norm(model.final_norm, h, cfg)
    logits = L.logits(model.embed, h, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux, (cache if collect_cache else None)


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
    """Zero decode cache at context length ``seq_len`` and the host-side
    step counter ``cur``.  dense: the ring k and v (L, B, clen, KVH, D) and
    the slot positions ``pos`` (clen,) (-1 = empty); ssm: the SSM states
    ``ssm`` (L, B, H, N, P) fp32 and the conv histories ``conv``
    (L, B, W-1, conv_dim); hybrid: both, with one ring (B, clen, KVH, D)
    for the shared block (no layer axis)."""
    check_family(cfg)
    device = facility.resolve_device(device)
    clen = cache_len(cfg, seq_len)
    c = {"cur": 0}
    if cfg.family in ("dense", "hybrid"):
        kv_shape = (batch, clen, cfg.num_kv_heads, cfg.head_dim)
        if cfg.family == "dense":
            kv_shape = (cfg.num_layers,) + kv_shape
        c["k"] = torch.zeros(kv_shape, dtype=dtype, device=device)
        c["v"] = torch.zeros(kv_shape, dtype=dtype, device=device)
        c["pos"] = torch.full((clen,), -1, dtype=torch.int32, device=device)
    if cfg.family in ("ssm", "hybrid"):
        _, nheads, conv_dim = M2.dims(cfg)
        c["ssm"] = torch.zeros((cfg.num_layers, batch, nheads, cfg.ssm_state,
                                cfg.ssm_headdim), dtype=torch.float32,
                               device=device)
        c["conv"] = torch.zeros((cfg.num_layers, batch,
                                 cfg.ssm_conv_width - 1, conv_dim),
                                dtype=dtype, device=device)
    return c


def _ring_insert(attn: L.Attention, hn, k_c, v_c, slot, cos_sin, cfg,
                 cast_weights: bool):
    """Project the new token's k/v (B, 1, KVH, D), rotate k, and write
    both into ring slot ``slot`` of ``k_c``/``v_c`` (B, clen, KVH, D) in
    place.  The dense path casts the weights to the activation dtype
    first, as the reference's dense decode does."""
    b = hn.shape[0]
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    wk, wv = attn.wk, attn.wv
    if cast_weights:
        wk, wv = wk.to(hn.dtype), wv.to(hn.dtype)
    knew = facility.contract(facility.DOT, hn, wk).reshape(b, 1, nkv, hd)
    vnew = facility.contract(facility.DOT, hn, wv).reshape(b, 1, nkv, hd)
    knew = L.apply_rope(knew, cos_sin[2], cos_sin[3])
    k_c[:, slot] = knew[:, 0].to(k_c.dtype)
    v_c[:, slot] = vnew[:, 0].to(v_c.dtype)


def _ssm_decode(layer: SSMBlock, h, cache, i, cfg):
    """One mamba2 layer's decode step; its state and conv history are
    written back into ``cache["ssm"][i]``/``cache["conv"][i]`` in place."""
    h, st = _apply_ssm_block(layer, h, cfg, state={"ssm": cache["ssm"][i],
                                                   "conv": cache["conv"][i]})
    cache["ssm"][i].copy_(st["ssm"])
    cache["conv"][i].copy_(st["conv"])
    return h


def decode_step(model: Model, cache, tokens, cfg):
    """One token for every sequence in the batch.  tokens (B, 1).

    Returns (logits (B, 1, V), new_cache).  The cache is updated IN PLACE
    (it is the largest state of a serving run, and copying it per token
    would double its traffic): the new token's k/v go into the ring slot
    ``cur % clen`` of ``cache["k"]``/``cache["v"]``, and each mamba2
    layer's new state and conv history overwrite ``cache["ssm"]`` and
    ``cache["conv"]``.  The returned dict shares those tensors and carries
    the advanced ``pos``/``cur``.
    """
    check_family(cfg)
    cur = cache["cur"]
    b = tokens.shape[0]
    h = L.embed_tokens(model.embed, tokens, cfg)
    emb0 = h
    new_cache = dict(cache, cur=cur + 1)
    if cfg.family == "ssm":
        for i, layer in enumerate(model.layers):
            h = _ssm_decode(layer, h, cache, i, cfg)
    else:
        pos_b = torch.full((b, 1), cur, dtype=torch.int32,
                           device=tokens.device)
        cos_sin = _cos_sin_for(cfg, pos_b)
        clen = cache["pos"].shape[0]
        slot = cur % clen
        kv_positions = cache["pos"].clone()
        kv_positions[slot] = cur
        kv_positions = kv_positions[None]                 # (1, clen)
        valid = kv_positions >= 0
        new_cache["pos"] = kv_positions[0]
        attn_kw = dict(cos_sin=cos_sin, q_offset=cur,
                       kv_positions=kv_positions, valid=valid)
    if cfg.family == "dense":
        for i, layer in enumerate(model.layers):
            hn = L.apply_norm(layer.attn_norm, h, cfg)
            k_c, v_c = cache["k"][i], cache["v"][i]
            _ring_insert(layer.attn, hn, k_c, v_c, slot, cos_sin, cfg,
                         cast_weights=True)
            h, _ = _apply_dense_block(layer, h, cfg, kv=(k_c, v_c),
                                      window=cfg.sliding_window, **attn_kw)
    elif cfg.family == "hybrid":
        for group in _groups(cfg):
            for i in group:
                h = _ssm_decode(model.layers[i], h, cache, i, cfg)
            h = _apply_shared_attn(model.shared_attn, h, emb0, cfg,
                                   ring=(cache["k"], cache["v"], slot),
                                   **attn_kw)
    h = L.apply_norm(model.final_norm, h, cfg)
    logits = L.logits(model.embed, h, cfg)
    return logits, new_cache
