"""Flash attention: the wrapper of the Hopper kernel, its plain version, the
host-side block schedule and the oracle (port of
``repro.kernels.mma_attention``, TPU kernel K2).

The kernel is ``csrc/mma_attention.cu``; its head comment says which TPU
kernel it replaces (``repro/kernels/mma_attention.py``,
``mma_flash_attention``), what bounds it on an H100 (the bf16 tensor cores
for prefill past a few hundred tokens, bytes for one query over a long
cache) and what its design does about that: one block per (b, h, 128-row
q tile; 64 rows where the grid would not fill the card) loops over its own
live KV blocks, with the bounds of :func:`attn_k_bounds` computed in the
kernel, on TMA loads and wgmma; short queries split their KV blocks over
several blocks (:func:`split_kv_plan`) and merge the partials by
log-sum-exp.  f32 q, k and v (K2e: the F32GER policy's operands) run the
kernel's fp32 tile, true fp32 FMAs on 64-row q tiles with P kept in fp32,
in both modes (the tile and split-KV, merged alike).

A CPU tensor goes to the plain version of what the card would run:
:func:`flash_attention_splitkv_plain` (per-split partials and their
merge) where :func:`split_kv_plan` splits, else
:func:`flash_attention_plain` (the two-product softmax of
:func:`ref_attention` plus the epilogue).  A CUDA tensor launches the
kernel or raises.  ``mma_flash_attention.launches`` counts attention
calls run on the card (the split-KV merge is part of its call), and
nothing else; ``mma_flash_attention.launches_by_mode`` the same by mode:
``tile`` and ``split`` (the 16-bit wgmma kernel), ``f32_tile`` and
``f32_split`` (the fp32 tile, K2e); ``padded_launches_by_mode`` those of
them whose depth was padded.

Head depths: the kernel is compiled for D = 32, 64, 128 and 192 (16-bit)
or 32, 64, 128 and 160 (fp32) (:data:`KERNEL_HEAD_DIMS`).  Any other D up
to the largest runs every mode at the next compiled depth: the wrapper
zero-pads q, k and v (and the epilogue's bias and residual), which leaves
every score unchanged, passes the softmax scale of the *logical* depth D
(never the padded one), and drops the padded output columns.  This is the
depth ABFT's attention check gives (``core/abft.py`` adds one checksum
column: deepseek's 128 becomes 129, run at 192; whisper's 64 becomes 65,
run at 128), whose q the reference pre-scales by sqrt((D + 1) / D) on
exactly that assumption.

Gradients: where q, k, v, bias or the residual requires one, the call
runs as a ``torch.autograd.Function``: the forward is the kernel (or the
plain version on the CPU), the backward differentiates a recomputation
through the torch lowering (``core.lowering.torch_attention``; no TPU
backward kernel exists, see ``kernels._autograd``) and launches nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.tiling import NUM_SMS
from repro_torch.kernels import _autograd, _build
from repro_torch.kernels import epilogue as _epilogue

NEG_INF = -1e30

# The kernel's tiles (csrc/mma_attention.cu): 128 query rows (two consumer
# warpgroups; 64 where the grid would not fill the card) by 64 KV rows.
BLOCK_Q, BLOCK_Q_SHORT, BLOCK_K = 128, 64, 64
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MODES = ("tile", "split", "f32_tile", "f32_split")
# The depths the kernel is compiled for, by operand dtype (the 16-bit
# wgmma kernel; the fp32 tile, whose 192 would not fit shared memory).
KERNEL_HEAD_DIMS = (32, 64, 128, 192)
F32_HEAD_DIMS = (32, 64, 128, 160)
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


# ----------------------------------------------------------------------
# Grid plan: the bounded (qi, ki) block schedule (pure, host-side)
# ----------------------------------------------------------------------

def attn_k_bounds(qi: int, nk: int, *, bq: int, bk: int, causal: bool,
                  q_offset: int = 0, window: int | None = None
                  ) -> tuple[int, int]:
    """[k_lo, k_hi) — KV block range with any structurally-live slot for
    query block ``qi``.  Causal bounds above (no block past the diagonal
    of the last row), the sliding window bounds below (no block whose last
    slot is already outside the first row's window).  Always non-empty:
    a fully-masked query block still runs one (masked) step so its output
    tile is deprimed (to zeros, via the masked-block guard).  The CUDA
    kernel computes the same bounds per block."""
    hi = nk
    if causal:
        hi = min(nk, -(-(q_offset + (qi + 1) * bq) // bk))
        hi = max(hi, 1)
    lo = 0
    if window is not None:
        lo = max(0, (q_offset + qi * bq - (window - 1)) // bk)
        lo = min(lo, hi - 1)
    return lo, hi


def attn_live_steps(sq: int, sk: int, bq: int, bk: int, *, causal: bool,
                    q_offset: int = 0, window: int | None = None) -> int:
    """Total (qi, ki) block steps the bounded schedule runs."""
    nq, nk = -(-sq // bq), -(-sk // bk)
    total = 0
    for qi in range(nq):
        lo, hi = attn_k_bounds(qi, nk, bq=bq, bk=bk, causal=causal,
                               q_offset=q_offset, window=window)
        total += hi - lo
    return total


def attn_live_pairs(sq: int, sk: int, *, causal: bool, q_offset: int = 0,
                    window: int | None = None) -> int:
    """Position-level live (q, k) pair count — the useful-FLOPs numerator
    of the roofline model (block-level padding is charged separately)."""
    q_pos = np.arange(sq) + q_offset
    hi = np.minimum(sk, q_pos + 1) if causal else np.full(sq, sk)
    lo = np.clip(q_pos - (window - 1), 0, sk) if window is not None \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attn_grid_plan(sq: int, sk: int, bq: int, bk: int, *, causal: bool,
                   q_offset: int = 0, window: int | None = None,
                   bound: bool = True) -> np.ndarray:
    """The block schedule as a (4, T) int32 array with rows ``qi``, ``ki``,
    ``first`` (this step primes qi's accumulator) and ``last`` (this step
    deprimes).  The kernel walks the same live steps, one q block per
    thread block; ``bound=False`` is the full rectangular schedule."""
    nq, nk = -(-sq // bq), -(-sk // bk)
    rows = []
    for qi in range(nq):
        lo, hi = (attn_k_bounds(qi, nk, bq=bq, bk=bk, causal=causal,
                                q_offset=q_offset, window=window)
                  if bound else (0, nk))
        for ki in range(lo, hi):
            rows.append((qi, ki, int(ki == lo), int(ki == hi - 1)))
    return np.asarray(rows, np.int32).T


def attn_block_q(b: int, h: int, sq: int) -> int:
    """The q tile: 128 rows, or 64 where 128-row tiles leave SMs idle."""
    return BLOCK_Q if -(-sq // BLOCK_Q) * b * h >= NUM_SMS else BLOCK_Q_SHORT


def split_kv_plan(h: int, sq: int, sk: int) -> tuple[int, int]:
    """(n_split, KV blocks per split) of a launch.  Queries of at most 64
    rows (one q tile) split their KV blocks so that one batch element's
    (h, split) blocks fill the card in one wave of two blocks per SM; each
    split walks ``per`` consecutive blocks of the tile's live range.
    Otherwise (1, all blocks).  The plan does not read the batch: a query
    row is summed in the same order at any B (a larger batch runs more
    waves), as the reference's kernel schedules each (b, h, q-block)
    alike."""
    nk = -(-sk // BLOCK_K)
    if sq > BLOCK_Q_SHORT or nk < 2:
        return 1, nk
    per = -(-nk // max(1, min(nk, 2 * NUM_SMS // h)))
    return -(-nk // per), per


# ----------------------------------------------------------------------
# The oracle and the plain versions
# ----------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, KVH * n_rep, D), each KV head repeated over
    its GQA group (the plain versions and the eager decode path; the
    kernel indexes KV head h // group instead)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def ref_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0, valid: torch.Tensor | None = None):
    """Two-product oracle on (B, S, H, D) operands; returns the fp32
    result.  Scores in fp32, softmax in fp32, the value product on P
    rounded to v's dtype with fp32 accumulation.  Rows whose every slot is
    masked yield exact zeros — the facility's fully-masked-row
    convention."""
    b, sq, h, d = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    k = repeat_kv(k, h // kvh)
    v = repeat_kv(v, h // kvh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d ** -0.5)
    q_pos = (torch.arange(sq, device=q.device) + q_offset)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)[None]
    if window is not None:
        mask = mask & (q_pos - k_pos < window)[None]
    if valid is not None:
        mask = mask & valid.to(torch.bool).reshape(-1, 1, sk)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, :, None], p, torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def flash_attention_plain(q, k, v, *, causal: bool = True, q_offset: int = 0,
                          window: int | None = None, valid=None,
                          ep: _epilogue.Epilogue | None = None, bias=None,
                          residual=None, out_dtype=None):
    """The plain version of the kernel: the oracle's two-product softmax,
    then the epilogue on the normalised fp32 output, then the cast."""
    out = ref_attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, valid=valid)
    out = _epilogue.apply(out, ep, bias=bias, residual=residual)
    return out.to(out_dtype or q.dtype)


def rounding_budget(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    window: int | None = None, valid=None,
                    ep: _epilogue.Epilogue | None = None):
    """Per-output bound, in fp32, on |kernel - plain version| before the
    final cast.  Both round each softmax weight p_i to v's dtype once --
    the kernel unnormalised against its running max, the plain versions
    normalised or against a split's max -- so each rounded weight is
    within u * p_i of the exact one (u = 2^-8 for bf16, 2^-11 for f16)
    and an output moves by at most 2u * sum_i p_i |v_i|: 2u times the
    oracle on |v|, plus 2^-12 of it for the fp32 scores, exponentials and
    sums in another order (a score off by D * 2^-24 * sum_d |q_d k_d| /
    sqrt(D), below 2^-14 relative at unit inputs and D = 128).  f32
    operands round no weight (P stays fp32), so only fp32 arithmetic in
    another order is left: (D + 8) * 2^-24 of the oracle on |v| -- D
    units for the scores (a sum of D products in two orders, at unit-scale
    scores), 4 for exp2f's two ulps and 4 for the sums over the keys.
    TF32 products (2^-11 relative a factor) or P rounded to bf16 land
    hundreds of such units away.  Times 1.13 (the largest slope of gelu
    and silu) under an activation.  A fully masked row has a budget of
    0."""
    u = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}.get(v.dtype)
    fp32 = 2.0 ** -12 if u else (q.shape[-1] + 8) * 2.0 ** -24
    slope = 1.13 if ep is not None and ep.activation is not None else 1.0
    mean_abs = ref_attention(q, k, v.abs(), causal=causal, window=window,
                             q_offset=q_offset, valid=valid)
    return (2 * (u or 0.0) + fp32) * slope * mean_abs


def _live_mask(sq, sk, k0, k1, *, causal, window, q_offset, valid, device):
    """(1|B, Sq, k1 - k0) predicate of slots k0..k1-1, as ref_attention's."""
    q_pos = (torch.arange(sq, device=device) + q_offset)[:, None]
    k_pos = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((1, sq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (q_pos >= k_pos)[None]
    if window is not None:
        mask = mask & (q_pos - k_pos < window)[None]
    if valid is not None:
        mask = mask & valid.to(torch.bool).reshape(-1, 1, sk)[..., k0:k1]
    return mask


def flash_attention_splitkv_plain(q, k, v, *, n_split: int, per: int,
                                  causal: bool = True, q_offset: int = 0,
                                  window: int | None = None, valid=None,
                                  ep: _epilogue.Epilogue | None = None,
                                  bias=None, residual=None, out_dtype=None):
    """The split-KV arithmetic of the kernel: split s covers ``per`` KV
    blocks of 64 from the q tile's first live block; each split keeps its
    own fp32 partial (unnormalised O with P = exp(S - m_s) rounded to v's
    dtype, its max m_s and sum l_s; a split with no live slot has
    m_s = -inf and zeros); the partials merge in split order by
    log-sum-exp, a row with l = 0 gives 0, then the epilogue and the
    cast.  Each batch element is computed on its own, as the kernel's
    blocks are, so a row's result does not depend on the batch around
    it."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    rows = None
    if valid is not None:
        rows = valid.to(torch.bool).reshape(-1, sk)
    out = torch.cat([_splitkv_one(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], n_split=n_split, per=per,
        causal=causal, q_offset=q_offset, window=window,
        valid=None if rows is None else rows[i % rows.shape[0]][None])
        for i in range(b)])
    out = _epilogue.apply(out, ep, bias=bias, residual=residual)
    return out.to(out_dtype or q.dtype)


def _splitkv_one(q, k, v, *, n_split, per, causal, q_offset, window,
                 valid):
    """One batch element's split-KV partials and their merge: the fp32
    (1, Sq, H, D) output before the epilogue."""
    _, sq, h, d = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    kr, vr = repeat_kv(k, h // kvh).float(), repeat_kv(v, h // kvh)
    lo, hi = attn_k_bounds(0, -(-sk // BLOCK_K), bq=BLOCK_Q_SHORT,
                           bk=BLOCK_K, causal=causal, q_offset=q_offset,
                           window=window)
    qf = q.float()
    parts = []
    for s in range(n_split):
        b0 = lo + s * per
        k0, k1 = min(sk, b0 * BLOCK_K), min(sk, min(hi, b0 + per) * BLOCK_K)
        if k1 <= k0:
            parts.append((torch.full((1, h, sq, 1), NEG_INF, device=q.device),
                          torch.zeros((1, h, sq, 1), device=q.device),
                          torch.zeros((1, h, sq, d), device=q.device)))
            continue
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kr[:, k0:k1]) * (d ** -0.5)
        live = _live_mask(sq, sk, k0, k1, causal=causal, window=window,
                          q_offset=q_offset, valid=valid,
                          device=q.device)[:, None]
        sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
        m_s = sc.amax(-1, keepdim=True)
        p = torch.where(live & (m_s > NEG_INF), torch.exp(sc - m_s),
                        torch.zeros_like(sc))
        o_s = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                           vr[:, k0:k1].float())
        parts.append((m_s, p.sum(-1, keepdim=True), o_s))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l_all = torch.zeros_like(m_all)
    o_all = torch.zeros((1, h, sq, d), device=q.device)
    for m_s, l_s, o_s in parts:              # split order
        w = torch.where(m_all > NEG_INF, torch.exp(m_s - m_all),
                        torch.zeros_like(m_s))
        l_all = l_all + w * l_s
        o_all = o_all + w * o_s
    out = o_all / torch.where(l_all == 0, torch.ones_like(l_all), l_all)
    return out.permute(0, 2, 1, 3)


# ----------------------------------------------------------------------
# The kernel wrapper
# ----------------------------------------------------------------------

def _lib():
    lib = _build.load("mma_attention")
    fn = lib.mma_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def mma_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        window: int | None = None,
                        valid: torch.Tensor | None = None,
                        ep: _epilogue.Epilogue | None = None,
                        bias: torch.Tensor | None = None,
                        residual: torch.Tensor | None = None,
                        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Fused attention over q (B, Sq, H, D) and k, v (B, Sk, KVH, D), with
    H % KVH == 0.  ``q_offset`` is the absolute position of q[0];
    ``window`` the sliding-window width (q attends k with
    ``q_pos - k_pos < window``); ``valid`` an optional (Sk,), (1, Sk) or
    (B, Sk) filled-slot predicate.  ``ep`` fuses bias (D,) / activation /
    residual (B, Sq, H, D) into the normalised store.  Differentiable
    where an operand requires a gradient (the module docstring says
    how)."""
    opts = dict(causal=causal, q_offset=q_offset, window=window, ep=ep,
                out_dtype=out_dtype)
    if _autograd.wants_grad(q, k, v, bias, residual):
        return _FlashAttentionFn.apply(q, k, v, valid, bias, residual, opts)
    return _mma_flash_attention(q, k, v, valid=valid, bias=bias,
                                residual=residual, **opts)


class _FlashAttentionFn(torch.autograd.Function):
    """Attention under autograd: the kernel forward; the backward
    differentiates the torch lowering's recomputation."""

    @staticmethod
    def forward(ctx, q, k, v, valid, bias, residual, opts):
        ctx.opts = opts
        ctx.res_dtype = residual.dtype if residual is not None else None
        ctx.save_for_backward(q, k, v, valid, bias)
        return _mma_flash_attention(q, k, v, valid=valid, bias=bias,
                                    residual=residual, **opts)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.core import lowering   # imports this module
        q, k, v, valid, bias = ctx.saved_tensors
        o = ctx.opts
        need = ctx.needs_input_grad

        def recomputed(q, k, v, bias):
            return lowering.torch_attention(
                q, k, v, causal=o["causal"], window=o["window"],
                q_offset=o["q_offset"], valid=valid,
                ep=_autograd.without_residual(o["ep"]), bias=bias,
                out_dtype=dout.dtype)

        dq, dk, dv, dbias = _autograd.recompute(
            recomputed, (q, k, v, bias), (need[0], need[1], need[2], need[4]),
            dout)
        return (dq, dk, dv, None, dbias,
                (dout.to(ctx.res_dtype) if need[5] else None), None)


def _mma_flash_attention(q, k, v, *, causal, q_offset, window, valid, ep,
                         bias, residual, out_dtype) -> torch.Tensor:
    """The dispatch of one attention call: the plain version on a CPU
    tensor, the kernel on a CUDA tensor."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"attention shapes {tuple(q.shape)} x "
                         f"{tuple(k.shape)} x {tuple(v.shape)} are "
                         f"inconsistent")
    if h % kvh:
        raise ValueError(f"H ({h}) must be a multiple of KVH ({kvh})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    ep = ep if ep is not None and not ep.is_identity else None
    if ep is not None:
        ep.validate(torch.float32, bias=bias, residual=residual)
    elif bias is not None or residual is not None:
        raise ValueError("bias/residual operands need an Epilogue")
    out_dtype = out_dtype or q.dtype
    n_split, per = split_kv_plan(h, sq, sk)
    flags = dict(causal=causal, q_offset=q_offset, window=window,
                 valid=valid, ep=ep, bias=bias, residual=residual,
                 out_dtype=out_dtype)
    if q.device.type == "cpu":
        if n_split > 1:
            return flash_attention_splitkv_plain(q, k, v, n_split=n_split,
                                                 per=per, **flags)
        return flash_attention_plain(q, k, v, **flags)
    if q.device.type != "cuda":
        raise ValueError(f"mma_flash_attention runs on cuda (or its plain "
                         f"version on cpu), not {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"the attention kernel takes f32/bf16/f16 q, k, v of one dtype, "
            f"not {q.dtype}/{k.dtype}/{v.dtype}")
    depths = F32_HEAD_DIMS if q.dtype == torch.float32 else KERNEL_HEAD_DIMS
    dp = next((c for c in depths if c >= d), None)
    if dp is None:
        raise NotImplementedError(f"head dim {d} is above the compiled "
                                  f"depths {depths}")
    if out_dtype not in _OUT_CODES:
        raise NotImplementedError(f"the attention kernel stores "
                                  f"f32/bf16/f16, not {out_dtype}")
    for t in (k, v, valid, bias, residual):
        if t is not None and t.device != q.device:
            raise ValueError(f"operands on {q.device} and {t.device}")
    if residual is not None and tuple(residual.shape) != (b, sq, h, d):
        raise ValueError(f"residual has shape {tuple(residual.shape)}")
    if bias is not None and tuple(bias.shape) != (d,):
        raise ValueError(f"bias has shape {tuple(bias.shape)}; want ({d},)")
    for t in (bias, residual):
        if t is not None and t.dtype not in _OUT_CODES:
            raise NotImplementedError(f"epilogue operand dtype {t.dtype}")
    if valid is not None:
        valid = torch.broadcast_to(valid.to(torch.bool).reshape(-1, sk),
                                   (b, sk)).to(torch.uint8).contiguous()
    if b * n_split > 65535:
        raise ValueError(f"grid too large for one launch: b={b} x "
                         f"{n_split} splits")
    if dp != d:
        # zero columns past the logical depth: the scores are unchanged
        q, k, v, bias, residual = (
            torch.nn.functional.pad(t, (0, dp - d)) if t is not None
            else None for t in (q, k, v, bias, residual))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bias = bias.contiguous() if bias is not None else None
    residual = residual.contiguous() if residual is not None else None
    out = torch.empty((b, sq, h, dp), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :d]         # an empty grid is not a launch
    ws_o = ws_ml = None
    if n_split > 1:
        ws_o = torch.empty((b, h, sq, n_split, dp), dtype=torch.float32,
                           device=q.device)
        ws_ml = torch.empty((b, h, sq, n_split, 2), dtype=torch.float32,
                            device=q.device)
    f32 = q.dtype == torch.float32
    # the fp32 tile has 64 query rows in both modes, as has the padded
    # depth 192 (its 128-row tile would spill its accumulators)
    bq = (BLOCK_Q_SHORT if n_split > 1 or f32 or dp == 192
          else attn_block_q(b, h, sq))
    lib = _lib()
    rc = lib.mma_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(),
        ws_o.data_ptr() if ws_o is not None else None,
        ws_ml.data_ptr() if ws_ml is not None else None,
        KERNEL_DTYPES[q.dtype],
        _OUT_CODES[bias.dtype] if bias is not None else 0,
        _OUT_CODES[residual.dtype] if residual is not None else 0,
        _OUT_CODES[out_dtype], b, sq, sk, h, kvh, dp, int(causal),
        int(q_offset), int(window or 0), float(d ** -0.5),
        _epilogue.ACT_CODES[ep.activation if ep is not None else None],
        bq, n_split, per, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "mma_flash_attention")
    mode = ("f32_" if f32 else "") + ("split" if n_split > 1 else "tile")
    mma_flash_attention.launches += 1
    mma_flash_attention.launches_by_mode[mode] += 1
    if mma_flash_attention.trace is not None:
        mma_flash_attention.trace.append(
            (b, sq, sk, h, kvh, d, q.dtype, bool(causal), int(q_offset),
             window, valid is not None, n_split))
    if dp != d:
        mma_flash_attention.padded_launches_by_mode[mode] += 1
        return out[..., :d].contiguous()
    return out


mma_flash_attention.launches = 0
mma_flash_attention.launches_by_mode = dict.fromkeys(MODES, 0)
# The launches at a padded depth (also in launches_by_mode), by mode.
mma_flash_attention.padded_launches_by_mode = dict.fromkeys(MODES, 0)
# A list to record (B, Sq, Sk, H, KVH, D, dtype, causal, q_offset, window,
# valid given, n_split) of each launch into, or None (chip_smoke.py).
mma_flash_attention.trace = None
