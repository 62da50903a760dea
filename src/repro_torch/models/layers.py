"""Transformer building blocks, all matrix math routed via the MMA facility
(port of ``repro.models.layers``).

Activations carry the reference's logical-axis annotations
(``parallel.api.shard``), and the parameter modules their axes trees
(``norm_axes`` ... ``embed_axes``); a parameter used outside a contraction
is read through ``parallel.api.full`` (a sharded DTensor leaf's global
value, a plain tensor as it is).

Parameters live in ``nn.Module``s, with weights in the reference's (in, out)
layout, used through ``contract(DOT, ...)``; every function takes
(module, inputs) and returns outputs, like the reference's functions on
parameter dicts.  Weights may be stored in bf16 at rest: the facility's
policy cast is then a no-op and gives the same values as the reference's
per-call cast.  bf16 rounds where the reference rounds: at every contract's
output, in ``apply_norm``, in ``apply_rope`` and in the gated product.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import facility, precision
from repro_torch.core.facility import DOT, Epilogue, Plan
from repro_torch.parallel import api as par
from repro_torch.parallel.api import shard

# Max query rows whose attention scores are live at once on the
# ring-buffer path (as the reference's Q_CHUNK).
Q_CHUNK = 1024


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _dense_init(gen, shape, *, device, dtype, in_axis: int = 0):
    """Normal(0, 1/fan_in) weights, fan_in = ``shape[in_axis]``, drawn in
    fp32 from ``gen``."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * shape[in_axis] ** -0.5).to(dtype)


# ----------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------

class Norm(nn.Module):
    """rmsnorm scale, or layernorm scale and bias; kept in fp32."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.scale = _param(scale)
        self.bias = _param(bias) if bias is not None else None


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk = _param(wq), _param(wk)
        self.wv, self.wo = _param(wv), _param(wo)


class MLP(nn.Module):
    def __init__(self, w1, w2, w3=None):
        super().__init__()
        self.w1, self.w2 = _param(w1), _param(w2)
        self.w3 = _param(w3) if w3 is not None else None


class Embed(nn.Module):
    def __init__(self, tok, unembed=None):
        super().__init__()
        self.tok = _param(tok)
        self.unembed = _param(unembed) if unembed is not None else None


def norm_axes(cfg, d=None):
    p = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        p["bias"] = ("embed",)
    return p


def attention_axes(cfg):
    return {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}


def mlp_axes(cfg, gated=None):
    gated = cfg.gated_mlp if gated is None else gated
    p = {"w1": ("embed", "mlp"), "w2": ("mlp", "embed")}
    if gated:
        p["w3"] = ("embed", "mlp")
    return p


def embed_axes(cfg):
    p = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["unembed"] = ("embed", "vocab")
    return p


def init_norm(cfg, d=None, *, device) -> Norm:
    d = d or cfg.d_model
    bias = (torch.zeros((d,), dtype=torch.float32, device=device)
            if cfg.norm == "layernorm" else None)
    return Norm(torch.ones((d,), dtype=torch.float32, device=device), bias)


def init_attention(gen, cfg, *, device, dtype) -> Attention:
    d = cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=device, dtype=dtype)
    return Attention(_dense_init(gen, (d, h * hd), **kw),
                     _dense_init(gen, (d, kv * hd), **kw),
                     _dense_init(gen, (d, kv * hd), **kw),
                     _dense_init(gen, (h * hd, d), **kw))


def init_mlp(gen, cfg, *, device, dtype, d_ff: int | None = None) -> MLP:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    w1 = _dense_init(gen, (d, f), **kw)
    w2 = _dense_init(gen, (f, d), **kw)
    w3 = _dense_init(gen, (d, f), **kw) if cfg.gated_mlp else None
    return MLP(w1, w2, w3)


def init_embed(gen, cfg, *, device, dtype) -> Embed:
    tok = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                      device=device, dtype=torch.float32) * 0.02
    unembed = (None if cfg.tie_embeddings else
               _dense_init(gen, (cfg.d_model, cfg.vocab_size),
                           device=device, dtype=dtype))
    return Embed(tok.to(dtype), unembed)


# ----------------------------------------------------------------------
# Norms and rotary embeddings
# ----------------------------------------------------------------------

def apply_norm(p: Norm, x: torch.Tensor, cfg) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * par.full(p.scale) + par.full(p.bias)
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * par.full(p.scale)
    return out.to(x.dtype)


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim//2)."""
    inv = _inv_freq(head_dim, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections):
    """M-RoPE: positions3 (3, B, S); ``sections`` partition head_dim//2
    into temporal/height/width frequency bands (arXiv:2409.12191), each
    band rotated by its own position row.  -> cos/sin (B, S, head_dim//2)."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    inv = _inv_freq(head_dim, theta, positions3.device)
    ang = positions3[..., None].to(torch.float32) * inv   # (3, B, S, hd/2)
    parts, start = [], 0
    for i, s in enumerate(sections):
        parts.append(ang[i, ..., start:start + s])
        start += s
    ang = torch.cat(parts, dim=-1)                         # (B, S, hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, S, H, D); cos/sin (B, S, D//2) -> rotate-half convention."""
    d2 = x.shape[-1] // 2
    xf1 = x[..., :d2].float()
    xf2 = x[..., d2:].float()
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Attention (GQA, optional sliding window, optional cross-attention)
# ----------------------------------------------------------------------

def _attend(q, k, v, q_pos, kv_pos, *, causal, window, valid):
    """One query block against full K/V: a policy wrapper over the
    facility's ``attend_chunk`` (shared with the torch attn lowering)."""
    cfg = facility.current()
    pol = precision.policy(cfg.ger)
    out = facility.attend_chunk(
        q.to(pol.x_dtype), k.to(pol.x_dtype), v.to(pol.y_dtype),
        q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
        valid=valid)
    return out.to(cfg.out_dtype)


def sdpa(q, k, v, *, causal, window=None, q_offset=0, kv_positions=None,
         valid=None, q_chunk: int = 0):
    """Scaled dot-product attention via the facility.

    q (B,Sq,H,D); k,v (B,Sk,KVH,D).  Prefill and training (dense
    positions) dispatch through the ``attn`` op-class, which the kernel
    backend runs on the flash kernel.  The ring-buffer decode path
    (``kv_positions`` given) masks by data positions in the explicit
    chunked two-product math below, as the reference does; it was never a
    kernel.
    """
    sq, sk = q.shape[1], k.shape[1]
    if kv_positions is None:
        plan = Plan(causal=causal, window=window, q_offset=int(q_offset),
                    q_chunk=q_chunk or Q_CHUNK)
        return facility.contract(
            facility.ATTN, q, k, v, plan=plan,
            masks=(valid,) if valid is not None else None)

    h, nkv = q.shape[2], k.shape[2]
    k = facility.repeat_kv(k, h // nkv)
    v = facility.repeat_kv(v, h // nkv)
    q_pos = (torch.arange(sq, device=q.device) + q_offset)[None, :]
    q_chunk = q_chunk or Q_CHUNK
    return torch.cat([
        _attend(q[:, s:s + q_chunk], k, v, q_pos[:, s:s + q_chunk],
                kv_positions, causal=causal, window=window, valid=valid)
        for s in range(0, sq, q_chunk)], dim=1)


def apply_attention(p: Attention, x, cfg, *, cos_sin=None, kv=None,
                    causal=None, window=None, q_offset=0,
                    kv_positions=None, valid=None, cross_x=None,
                    residual=None):
    """Full attention block: projections + RoPE + SDPA + output proj.
    ``cross_x``: keys and values are projected from the encoder stream
    (whisper's decoder).  ``residual`` is fused into the output
    projection's store.  Returns (out, (k, v)) so callers can build KV
    caches."""
    b, s, d = x.shape
    h, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = facility.contract(DOT, x, p.wq).reshape(b, s, h, hd)
    if kv is None:
        src = cross_x if cross_x is not None else x
        sk = src.shape[1]
        k = facility.contract(DOT, src, p.wk).reshape(b, sk, nkv, hd)
        v = facility.contract(DOT, src, p.wv).reshape(b, sk, nkv, hd)
    else:
        k, v = kv
    if cos_sin is not None:
        qcos, qsin, kcos, ksin = cos_sin
        q = apply_rope(q, qcos, qsin)
        if kv is None:                  # fresh keys need rotating
            k = apply_rope(k, kcos, ksin)
    q = shard(q, "batch", None, "heads", None)
    # decode caches shard the KV sequence (flash-decode); fresh keys in
    # training shard heads instead: 'model' can only appear once
    k = shard(k, "batch", "seq_kv" if kv is not None else None,
              None if kv is not None else "kv_heads", None)
    causal = cfg.causal if causal is None else causal
    out = sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset,
               kv_positions=kv_positions, valid=valid)
    out = facility.contract(DOT, out.reshape(b, s, h * hd), p.wo,
                            residual=residual)
    return out, (k, v)


# ----------------------------------------------------------------------
# MLP (gated / plain)
# ----------------------------------------------------------------------

def apply_mlp(p: MLP, x, cfg, residual=None):
    """MLP with both epilogues fused: the activation rides the w1 GEMM's
    store (computed on the fp32 accumulator) and the block residual rides
    the w2 GEMM's."""
    h = facility.contract(DOT, x, p.w1,
                          plan=Plan(epilogue=Epilogue(activation=cfg.act)))
    h = shard(h, "batch", None, "mlp")
    if cfg.gated_mlp:
        h = h * facility.contract(DOT, x, p.w3)
    return facility.contract(DOT, h, p.w2, residual=residual)


# ----------------------------------------------------------------------
# Embeddings / logits
# ----------------------------------------------------------------------

def embed_tokens(p: Embed, tokens, cfg, dtype=torch.bfloat16):
    # Index first, then cast: the same values as the reference's
    # cast-then-index, without a pass over the whole table per call.
    return par.full(p.tok)[tokens].to(dtype)


def logits(p: Embed, x, cfg):
    w = par.full(p.tok).T if cfg.tie_embeddings else p.unembed
    return facility.contract(DOT, x, w.to(x.dtype),
                             plan=Plan(out_dtype=torch.float32))
