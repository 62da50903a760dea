"""Mamba2 / SSD (state-space duality) blocks (port of
``repro.models.mamba2``; arXiv:2405.21060).

The SSD chunked algorithm is a sequence of small-matrix rank-k updates
(intra-chunk "attention-like" products, chunk-state outer products,
inter-chunk state propagation), so every product below routes through the
facility: the four SSD contractions are batched GEMMs (the GEMM kernel),
and the causal conv is the depthwise conv spec (the depthwise kernel).

Layout, as in the reference: x (B, L, H, P) with H = d_inner / headdim
heads, P = headdim, N = d_state, a single B/C group (ngroups = 1); the
conv runs on (B, L, conv_dim) with taps (W, conv_dim).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import facility
from repro_torch.core.facility import DOT, Epilogue, Plan
from repro_torch.core.precision import Ger
from repro_torch.models import layers as L


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, nheads, conv_dim


class Mamba2(nn.Module):
    """One mamba2 block's parameters.  ``in_proj`` (d, 2*d_in + 2*N + H)
    is the fused [z, x, B, C, dt] projection and may be stored in bf16;
    the conv taps ``conv_w`` (W, conv_dim) and the 1-D parameters stay
    fp32 (the conv runs F32GER, which reads the taps as fp32)."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D, dt_bias,
                 norm_scale, out_proj):
        super().__init__()
        self.in_proj, self.out_proj = L._param(in_proj), L._param(out_proj)
        self.conv_w, self.conv_b = L._param(conv_w), L._param(conv_b)
        self.A_log, self.D = L._param(A_log), L._param(D)
        self.dt_bias = L._param(dt_bias)
        self.norm_scale = L._param(norm_scale)


def init_mamba2(gen, cfg, *, device, dtype) -> Mamba2:
    d = cfg.d_model
    d_in, nheads, conv_dim = dims(cfg)
    n = cfg.ssm_state
    f32 = dict(device=device, dtype=torch.float32)
    in_proj = L._dense_init(gen, (d, 2 * d_in + 2 * n + nheads),
                            device=device, dtype=dtype)
    conv_w = torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                         **f32) * 0.1
    out_proj = L._dense_init(gen, (d_in, d), device=device, dtype=dtype)
    return Mamba2(in_proj, conv_w, torch.zeros((conv_dim,), **f32),
                  torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
                  torch.ones((nheads,), **f32),
                  torch.zeros((nheads,), **f32),
                  torch.ones((d_in,), **f32), out_proj)


def _split_proj(proj, cfg):
    d_in, nheads, _ = dims(cfg)
    n = cfg.ssm_state
    return torch.split(proj, [d_in, d_in + 2 * n, nheads], dim=-1)


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv, width W, with bias + silu fused into the
    store.  conv_state: (B, W-1, C) history.

    The decode path prepends the history and runs VALID; the prefill path
    is the architected causal (left) padding.  F32GER keeps the tap
    products in fp32.  Returns (out, new history).
    """
    w = conv_w.shape[0]
    if conv_state is not None:
        xin = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        padding = "valid"
    else:
        xin = xbc
        padding = "causal"
    out = facility.contract(
        facility.CONV1D_DEPTHWISE, xin, conv_w, bias=conv_b,
        plan=Plan(ger=Ger.F32GER, padding=padding,
                  epilogue=Epilogue(bias=True, activation="silu"),
                  out_dtype=xbc.dtype))
    if conv_state is not None:
        return out, xin[:, -(w - 1):, :]
    # New history = the last W-1 input frames, zero-prefixed for short
    # sequences (the causal padding itself stays inside the conv lowering).
    l = xbc.shape[1]
    state = (xbc[:, -(w - 1):, :] if l >= w - 1
             else torch.nn.functional.pad(xbc, (0, 0, w - 1 - l, 0)))
    return out, state


def _segsum(dA):
    """Stable segment-sum: out[..., i, j] = sum dA[..., j+1..i] (j <= i),
    -inf above the diagonal."""
    l = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=dA.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, D, chunk, return_state: bool = False):
    """SSD scan (ssd_minimal_discrete, Mamba2 paper listing 1).

    x (b,l,h,p); dt (b,l,h) [post-softplus]; A (h,) negative decay;
    B, C (b,l,n).  Returns y (b,l,h,p) [, final_state (b,h,n,p) fp32] —
    the final state is the prefill -> decode handoff.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc = l // chunk
    # discretize
    dA = dt * A                                           # (b,l,h)
    xt = (x * dt[..., None]).to(x.dtype)                  # dt-weighted input

    def r(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, Bc, Cc = r(xt), r(B), r(C)
    dAc = r(dA).permute(0, 1, 3, 2)                       # (b,nc,h,L)
    dA_cum = torch.cumsum(dAc, dim=-1)                    # (b,nc,h,L)

    # 1) intra-chunk (the "quadratic attention" branch of the duality)
    Lmat = torch.exp(_segsum(dAc))                        # (b,nc,h,L,L)
    scores = facility.contract("bcln,bcsn->bcls", Cc, Bc,
                               plan=Plan(out_dtype=torch.float32))
    att = scores[:, :, None] * Lmat                       # (b,nc,h,L,L)
    y_intra = facility.contract("bchls,bcshp->bclhp", att.to(x.dtype), xc)

    # 2) chunk states: decayed outer products B^T (dt x)
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)   # (b,nc,h,L)
    states = facility.contract(
        "bcln,bclhp->bchnp", Bc,
        (xc * decay_states.permute(0, 1, 3, 2)[..., None]).to(x.dtype),
        plan=Plan(out_dtype=torch.float32))               # (b,nc,h,n,p)

    # 3) inter-chunk recurrence (a loop over chunks; the carry before each
    # chunk is that chunk's incoming state)
    chunk_decay = torch.exp(dA_cum[..., -1])              # (b,nc,h)
    carry = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (b,nc,h,n,p)

    # 4) state -> output contribution
    state_decay = torch.exp(dA_cum)                       # (b,nc,h,L)
    y_inter = facility.contract("bcln,bchnp->bclhp", Cc,
                                prev_states.to(x.dtype))
    y_inter = y_inter * state_decay.permute(0, 1, 3, 2)[..., None].to(x.dtype)

    y = (y_intra.float() + y_inter.float()
         + x.reshape(b, nc, chunk, h, p).float() * D[:, None])
    y = y.reshape(b, l, h, p).to(x.dtype)
    if return_state:
        return y, carry
    return y


def apply_mamba2(p: Mamba2, x, cfg, state=None):
    """Full block.  Prefill: state=None, the sequence scanned in chunks.
    Decode: x (B, 1, d) with state {'ssm', 'conv'} -> (out, new_state)."""
    b, l, d = x.shape
    d_in, nheads, _ = dims(cfg)
    n = cfg.ssm_state
    proj = facility.contract(DOT, x, p.in_proj)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    dt = torch.nn.functional.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    if state is None:
        xbc_raw = xbc
        xbc, _ = _causal_conv(xbc, p.conv_w, p.conv_b)
        xs, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
        xh = xs.reshape(b, l, nheads, cfg.ssm_headdim)
        chunk = min(cfg.ssm_chunk, l)     # short-sequence prefill
        y, final = ssd_chunked(xh, dt, A, B, C, p.D, chunk,
                               return_state=True)
        # prefill -> decode handoff: final SSM state + conv tail
        w = cfg.ssm_conv_width
        tail = torch.nn.functional.pad(xbc_raw, (0, 0, w - 1, 0))
        new_state = {"ssm": final, "conv": tail[:, -(w - 1):, :]}
    else:
        xbc, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b,
                                       conv_state=state["conv"])
        xs, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
        xh = xs.reshape(b, l, nheads, cfg.ssm_headdim)
        # single-token recurrent update: s <- exp(dt A) s + dt B x
        dA = torch.exp(dt[:, 0] * A)                      # (b,h)
        upd = facility.contract(
            "bn,bhp->bhnp", B[:, 0],
            (xh[:, 0] * dt[:, 0, :, None]).to(x.dtype),
            plan=Plan(out_dtype=torch.float32))
        sstate = state["ssm"] * dA[..., None, None] + upd
        y = facility.contract("bn,bhnp->bhp", C[:, 0], sstate.to(x.dtype))
        y = y.float() + xh[:, 0].float() * p.D[:, None]
        y = y[:, None].to(x.dtype)
        new_state = {"ssm": sstate, "conv": conv_state}

    y = y.reshape(b, l, d_in)
    # gated RMSNorm (the mamba2 block's output norm)
    g = y * torch.nn.functional.silu(z.float()).to(y.dtype)
    gf = g.float()
    g = (gf * torch.rsqrt((gf * gf).mean(-1, keepdim=True) + cfg.norm_eps)
         * p.norm_scale).to(x.dtype)
    return facility.contract(DOT, g, p.out_proj), new_state


def init_decode_state(cfg, batch, *, device, dtype=torch.float32):
    _, nheads, conv_dim = dims(cfg)
    return {
        "ssm": torch.zeros((batch, nheads, cfg.ssm_state, cfg.ssm_headdim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }
