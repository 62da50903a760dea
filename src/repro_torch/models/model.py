"""Model assembly: init / forward / prefill / decode (port of
``repro.models.model``).

The reference scans over stacked layer pytrees; here the layers are an
``nn.ModuleList`` and the scan is a Python loop.  Ported families: dense
(llama lineage incl. GQA + SWA: deepseek-7b/67b, glm4-9b, h2o-danube), ssm
(mamba2), hybrid (zamba2: mamba2 groups with one shared attention block
applied after every ``shared_attn_every`` layers, on concat(h, embedding)),
audio (whisper: an encoder behind a two-conv stem, decoder blocks with
cross-attention over its output) and vlm (qwen2-vl: dense blocks with
M-RoPE, the leading ``vision_prefix`` positions fed by a patch-embed conv
stem).  moe raises ``NotImplementedError`` naming its ROADMAP slice.

``loss_fn`` is the training objective; gradients flow through every
kernel wrapper (each is a ``torch.autograd.Function`` where an operand
requires one), and the parameters ``init_params`` builds are frozen
until ``train.steps.init_train_state`` makes them trainable.

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

_LATER_FAMILIES = {"moe": "ROADMAP slice B1 (models/moe.py)"}
# family -> the kind of its main layer stack, as the reference's _main_kind
_KINDS = {"dense": "dense", "ssm": "ssm", "hybrid": "hybrid",
          "audio": "cross", "vlm": "dense"}


def check_family(cfg) -> str:
    """The kind of ``cfg``'s main layer stack; raises for a family that is
    not ported yet."""
    if cfg.family not in _KINDS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet — "
            f"{_LATER_FAMILIES.get(cfg.family, 'no slice planned')}")
    return _KINDS[cfg.family]


class DenseBlock(nn.Module):
    """Self attention and the MLP; whisper's decoder blocks (the "cross"
    kind) also hold ``cross_norm`` and the ``cross`` attention."""

    def __init__(self, attn_norm: L.Norm, attn: L.Attention,
                 mlp_norm: L.Norm, mlp: L.MLP,
                 cross_norm: L.Norm | None = None,
                 cross: L.Attention | None = None):
        super().__init__()
        self.attn_norm, self.attn = attn_norm, attn
        self.mlp_norm, self.mlp = mlp_norm, mlp
        self.cross_norm, self.cross = cross_norm, cross


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


class Frontend(nn.Module):
    """whisper's conv stem: ``conv1`` (3, n_mels, d) k3 s1 and ``conv2``
    (3, d, d) k3 s2, SAME padding, bias + gelu fused; fp32 at rest (the
    lowering casts them by policy)."""

    def __init__(self, conv1_w, conv1_b, conv2_w, conv2_b):
        super().__init__()
        self.conv1_w, self.conv1_b = L._param(conv1_w), L._param(conv1_b)
        self.conv2_w, self.conv2_b = L._param(conv2_w), L._param(conv2_b)


class Encoder(nn.Module):
    """whisper's encoder: its ``DenseBlock``s (non-causal), final norm and
    the conv stem (None for stub configs, whose frames are embeddings)."""

    def __init__(self, layers, norm: L.Norm, frontend: Frontend | None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm
        self.frontend = frontend


class VisionPatch(nn.Module):
    """qwen2-vl's patch-embed stem: ``patch_w`` (ps, ps, C, d), kernel =
    stride = patch size, and its bias; fp32 at rest."""

    def __init__(self, patch_w, patch_b):
        super().__init__()
        self.patch_w, self.patch_b = L._param(patch_w), L._param(patch_b)


class Model(nn.Module):
    """Embedding, the layer stack (``DenseBlock``s or ``SSMBlock``s), the
    hybrid family's shared attention block, the final norm, and the
    modality inputs: the audio kind's ``encoder``, the vision kind's
    ``vision_proj`` (d, d) and ``vision_patch`` stem."""

    def __init__(self, embed: L.Embed, layers, final_norm: L.Norm,
                 shared_attn: SharedAttn | None = None,
                 encoder: Encoder | None = None, vision_proj=None,
                 vision_patch: VisionPatch | None = None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.shared_attn = shared_attn
        self.encoder = encoder
        self.vision_proj = (L._param(vision_proj) if vision_proj is not None
                            else None)
        self.vision_patch = vision_patch


# ======================================================================
# Parameters
# ======================================================================

def init_params(cfg, *, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> Model:
    """Random weights drawn from a seeded ``torch.Generator`` on ``device``
    (default: the card; raises when CUDA is absent).  ``dtype`` is the
    storage dtype of the projection weights (bf16 at rest for serving);
    norm scales, the SSM's 1-D parameters, its conv taps and the conv
    stems' filters and biases stay fp32.  The values are not the
    reference's: torch cannot reproduce ``jax.random`` streams (tests carry
    the reference's weights over through ``models.convert``)."""
    kind = check_family(cfg)
    device = facility.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    embed = L.init_embed(gen, cfg, **kw)

    def dense_block(cross: bool = False) -> DenseBlock:
        extra = ((L.init_norm(cfg, device=device),
                  L.init_attention(gen, cfg, **kw)) if cross else ())
        return DenseBlock(L.init_norm(cfg, device=device),
                          L.init_attention(gen, cfg, **kw),
                          L.init_norm(cfg, device=device),
                          L.init_mlp(gen, cfg, **kw), *extra)

    def conv_init(shape):
        """Normal(0, 1/fan_in) fp32 filters, fan_in = all but the last."""
        fan_in = 1
        for n in shape[:-1]:
            fan_in *= n
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w * fan_in ** -0.5

    def zeros(d):
        return torch.zeros((d,), dtype=torch.float32, device=device)

    if kind in ("dense", "cross"):
        layers = [dense_block(kind == "cross") for _ in range(cfg.num_layers)]
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
    d = cfg.d_model
    encoder = vision_proj = vision_patch = None
    if cfg.is_enc_dec:
        frontend = None
        if not cfg.frontend_stub:
            frontend = Frontend(conv_init((3, cfg.n_mels, d)), zeros(d),
                                conv_init((3, d, d)), zeros(d))
        encoder = Encoder([dense_block() for _ in range(cfg.encoder_layers)],
                          L.init_norm(cfg, device=device), frontend)
    if cfg.vision_prefix:
        vision_proj = L._dense_init(gen, (d, d), **kw)
        if not cfg.frontend_stub and cfg.patch_size:
            ps, c = cfg.patch_size, cfg.image_channels
            vision_patch = VisionPatch(conv_init((ps, ps, c, d)), zeros(d))
    return Model(embed, layers, L.init_norm(cfg, device=device), shared,
                 encoder, vision_proj, vision_patch)


# ======================================================================
# Blocks
# ======================================================================

def _apply_dense_block(bp: DenseBlock, h, cfg, *, cos_sin, causal=None,
                       cross_x=None, kv=None, window=None, q_offset=0,
                       kv_positions=None, valid=None):
    """Self attention, then (with ``cross_x`` and a cross block)
    cross-attention over the encoder stream, then the MLP.  Returns (h,
    self (k, v), cross (k, v) or None)."""
    hn = L.apply_norm(bp.attn_norm, h, cfg)
    # Residual adds ride the output-projection / w2 GEMM epilogues.
    h, kv_out = L.apply_attention(
        bp.attn, hn, cfg, cos_sin=cos_sin, kv=kv, causal=causal,
        window=window, q_offset=q_offset, kv_positions=kv_positions,
        valid=valid, residual=h)
    cross_kv = None
    if cross_x is not None and bp.cross is not None:
        hn = L.apply_norm(bp.cross_norm, h, cfg)
        h, cross_kv = L.apply_attention(bp.cross, hn, cfg, causal=False,
                                        cross_x=cross_x, residual=h)
    hn = L.apply_norm(bp.mlp_norm, h, cfg)
    h = L.apply_mlp(bp.mlp, hn, cfg, residual=h)
    return h, kv_out, cross_kv


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
    """positions: (B, S) absolute, or (3, B, S) for M-RoPE."""
    if cfg.mrope:
        cos, sin = L.mrope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                                   cfg.mrope_sections)
    else:
        cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    return (cos, sin, cos, sin)


# ======================================================================
# Forward (training / prefill / encoder)
# ======================================================================

def _vision_patch_embed(model: Model, images, cfg):
    """qwen2-vl's patch-embed stem: raw images (B, gh*ps, gw*ps, C) through
    ONE facility CONV2D with kernel = stride = patch size (the stem is a
    GEMM over the patch matrix, paper eq. 8), the bias fused into its
    store.  Returns (B, vision_prefix, d_model) patch embeddings."""
    vp = model.vision_patch
    ps = cfg.patch_size
    h = facility.contract(
        facility.CONV2D, images.float(), vp.patch_w, bias=vp.patch_b,
        plan=facility.Plan(stride=ps, padding="valid",
                           epilogue=facility.Epilogue(bias=True)))
    b, gh, gw, d = h.shape
    if gh * gw != cfg.vision_prefix:
        raise ValueError(
            f"image grid {gh}x{gw} does not cover vision_prefix="
            f"{cfg.vision_prefix}; expected {cfg.vision_grid()} patches "
            f"of edge {ps}")
    return h.reshape(b, gh * gw, d)


def _embed_inputs(model: Model, batch, cfg):
    """Token (+ modality-stem) embedding; returns (h, positions).  The
    vision kind replaces its leading ``vision_prefix`` positions by the
    projected patch embeddings of ``batch["images"]`` (or by the
    precomputed ``vision_embeds`` of stub configs) and takes its M-RoPE
    positions (3, B, S) from the batch."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = L.embed_tokens(model.embed, tokens, cfg)
    if cfg.vision_prefix:
        if not cfg.frontend_stub and cfg.patch_size and "images" in batch:
            ve = _vision_patch_embed(model, batch["images"], cfg)
        elif "vision_embeds" in batch:
            ve = batch["vision_embeds"]
        else:
            ve = None
        if ve is not None:
            ve = facility.contract(facility.DOT, ve.to(h.dtype),
                                   model.vision_proj)
            dt = torch.promote_types(ve.dtype, h.dtype)
            h = torch.cat([ve.to(dt), h[:, cfg.vision_prefix:].to(dt)], dim=1)
    if cfg.mrope:
        positions = batch["positions"]
    else:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return h, positions


def _run_encoder(model: Model, frames, cfg):
    """whisper's encoder.  ``frames`` (B, T, n_mels) mel frames go through
    the two-conv stem (k3 s1 + k3 s2, SAME, bias + gelu fused into each
    conv's store), or are (B, T, d_model) embeddings when
    ``cfg.frontend_stub``; then the non-causal blocks and the norm."""
    enc = model.encoder
    if cfg.frontend_stub:
        h = frames.to(torch.bfloat16)
    else:
        fe = enc.frontend
        gelu = facility.Epilogue(bias=True, activation="gelu")
        h = facility.contract(
            facility.CONV1D, frames.float(), fe.conv1_w, bias=fe.conv1_b,
            plan=facility.Plan(padding="same", epilogue=gelu))
        h = facility.contract(
            facility.CONV1D, h, fe.conv2_w, bias=fe.conv2_b,
            plan=facility.Plan(stride=2, padding="same", epilogue=gelu))
    b, s, _ = h.shape
    pos = torch.arange(s, device=h.device)[None].expand(b, s)
    cos_sin = _cos_sin_for(cfg, pos)
    for layer in enc.layers:
        h, _, _ = _apply_dense_block(layer, h, cfg, cos_sin=cos_sin,
                                     causal=False)
    return L.apply_norm(enc.norm, h, cfg)


def forward(model: Model, batch, cfg, *, collect_cache: bool = False):
    """Teacher-forced forward pass.  Returns (logits, aux, cache|None).
    The cache, as the reference's: dense, vlm and audio, ``cache["kv"]``,
    the (k, v) pair stacked over layers, (L, B, S, KVH, D) each, and for
    audio also ``"cross_kv"``, the decoder's cross-attention (k, v) over
    the encoder's positions; ssm, ``"ssm"`` (L, B, H, N, P) fp32 and
    ``"conv"`` (L, B, W-1, conv_dim); hybrid, nothing (its shared block's
    cache is not collected)."""
    kind = check_family(cfg)
    h, positions = _embed_inputs(model, batch, cfg)
    emb0 = h
    cross_x = (_run_encoder(model, batch["frames"], cfg) if cfg.is_enc_dec
               else None)
    cos_sin = None if kind == "ssm" else _cos_sin_for(cfg, positions)
    cache = {}
    if kind in ("dense", "cross"):
        kvs, ckvs = [], []
        for layer in model.layers:
            h, kv, ckv = _apply_dense_block(
                layer, h, cfg, cos_sin=cos_sin, cross_x=cross_x,
                window=cfg.sliding_window)
            if collect_cache:
                kvs.append(kv)
                ckvs.append(ckv)
        if collect_cache:
            cache["kv"] = tuple(torch.stack(t) for t in zip(*kvs))
            if cfg.is_enc_dec:
                cache["cross_kv"] = tuple(torch.stack(t) for t in zip(*ckvs))
    elif kind == "ssm":
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


def loss_fn(model: Model, batch, cfg):
    """Teacher-forced loss: the masked mean NLL of ``batch["labels"]``
    (a label < 0 is masked) under the log-softmax of the fp32 logits, plus
    the forward's aux loss.  Returns (loss + aux, {"nll", "aux"})."""
    logits, aux, _ = forward(model, batch, cfg)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    mask = labels >= 0
    nll = -torch.gather(logp, -1, torch.where(mask, labels, 0).to(
        torch.int64)[..., None])[..., 0]
    maskf = mask.to(torch.float32)
    loss = (nll * maskf).sum() / torch.clip(maskf.sum(), min=1.0)
    return loss + aux, {"nll": loss, "aux": aux}


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
    step counter ``cur``.  dense, vlm and audio: the ring k and v
    (L, B, clen, KVH, D) and the slot positions ``pos`` (clen,) (-1 =
    empty); audio caps its decoder ring at ``decoder_len`` and adds the
    cross-attention ``cross_k``/``cross_v`` (L, B, encoder_len(seq_len),
    KVH, D), which the caller fills from prefill's ``cross_kv``; ssm: the
    SSM states ``ssm`` (L, B, H, N, P) fp32 and the conv histories
    ``conv`` (L, B, W-1, conv_dim); hybrid: both, with one ring
    (B, clen, KVH, D) for the shared block (no layer axis)."""
    kind = check_family(cfg)
    device = facility.resolve_device(device)
    clen = cache_len(cfg, seq_len)
    if cfg.is_enc_dec:
        # whisper: the decoder's self k/v is bounded by decoder_len; the
        # encoder's (cross) k/v carries the long seq_len context.
        clen = min(clen, cfg.decoder_len)
    c = {"cur": 0}
    if kind in ("dense", "cross", "hybrid"):
        kv_shape = (batch, clen, cfg.num_kv_heads, cfg.head_dim)
        if kind != "hybrid":
            kv_shape = (cfg.num_layers,) + kv_shape
        c["k"] = torch.zeros(kv_shape, dtype=dtype, device=device)
        c["v"] = torch.zeros(kv_shape, dtype=dtype, device=device)
        c["pos"] = torch.full((clen,), -1, dtype=torch.int32, device=device)
    if cfg.is_enc_dec:
        xs = (cfg.num_layers, batch, cfg.encoder_len(seq_len),
              cfg.num_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(xs, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(xs, dtype=dtype, device=device)
    if kind in ("ssm", "hybrid"):
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

    The audio kind runs each decoder block in the reference's decode
    order, which differs from its forward's: self attention over the ring
    and the MLP, then cross-attention over ``cross_k``/``cross_v`` added
    to the block's output.  The vision kind rotates by the M-RoPE
    positions (cur, cur, cur).
    """
    kind = check_family(cfg)
    cur = cache["cur"]
    b = tokens.shape[0]
    h = L.embed_tokens(model.embed, tokens, cfg)
    emb0 = h
    new_cache = dict(cache, cur=cur + 1)
    if kind == "ssm":
        for i, layer in enumerate(model.layers):
            h = _ssm_decode(layer, h, cache, i, cfg)
    else:
        pos_b = torch.full((b, 1), cur, dtype=torch.int32,
                           device=tokens.device)
        cos_sin = _cos_sin_for(cfg, pos_b.expand(3, b, 1) if cfg.mrope
                               else pos_b)
        clen = cache["pos"].shape[0]
        slot = cur % clen
        kv_positions = cache["pos"].clone()
        kv_positions[slot] = cur
        kv_positions = kv_positions[None]                 # (1, clen)
        valid = kv_positions >= 0
        new_cache["pos"] = kv_positions[0]
        attn_kw = dict(cos_sin=cos_sin, q_offset=cur,
                       kv_positions=kv_positions, valid=valid)
    if kind in ("dense", "cross"):
        for i, layer in enumerate(model.layers):
            hn = L.apply_norm(layer.attn_norm, h, cfg)
            k_c, v_c = cache["k"][i], cache["v"][i]
            _ring_insert(layer.attn, hn, k_c, v_c, slot, cos_sin, cfg,
                         cast_weights=True)
            h, _, _ = _apply_dense_block(layer, h, cfg, kv=(k_c, v_c),
                                         window=cfg.sliding_window,
                                         **attn_kw)
            if kind == "cross":
                hn = L.apply_norm(layer.cross_norm, h, cfg)
                ca, _ = L.apply_attention(
                    layer.cross, hn, cfg, causal=False,
                    kv=(cache["cross_k"][i], cache["cross_v"][i]))
                h = h + ca
    elif kind == "hybrid":
        for group in _groups(cfg):
            for i in group:
                h = _ssm_decode(model.layers[i], h, cache, i, cfg)
            h = _apply_shared_attn(model.shared_attn, h, emb0, cfg,
                                   ring=(cache["k"], cache["v"], slot),
                                   **attn_kw)
    h = L.apply_norm(model.final_norm, h, cfg)
    logits = L.logits(model.embed, h, cfg)
    return logits, new_cache
