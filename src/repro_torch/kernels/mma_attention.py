"""Flash attention: the wrapper of the Hopper kernel, its plain version, the
host-side block schedule and the oracle (port of
``repro.kernels.mma_attention``, TPU kernel K2).

The kernel is ``csrc/mma_attention.cu``; its head comment says which TPU
kernel it replaces (``repro/kernels/mma_attention.py``,
``mma_flash_attention``), what bounds it on an H100 (the bf16 tensor cores
for prefill past a few hundred tokens) and what its design does about that:
one block per (b, h, 64-row q block) loops over its own live KV blocks,
with the bounds of :func:`attn_k_bounds` computed in the kernel.

A CPU tensor goes to :func:`flash_attention_plain`: the two-product
softmax of :func:`ref_attention` plus the epilogue.  A CUDA tensor launches
the kernel or raises.  ``mma_flash_attention.launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as _epilogue

NEG_INF = -1e30

# The kernel's tile (csrc/mma_attention.cu: BQ, BKV).
BLOCK_Q = BLOCK_K = 64
KERNEL_DTYPES = {torch.bfloat16: 1, torch.float16: 2}
KERNEL_HEAD_DIMS = (32, 64, 128)
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])


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


# ----------------------------------------------------------------------
# The oracle and the plain version
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
    residual (B, Sq, H, D) into the normalised store."""
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
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, q_offset=q_offset, window=window,
            valid=valid, ep=ep, bias=bias, residual=residual,
            out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"mma_flash_attention runs on cuda (or its plain "
                         f"version on cpu), not {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"the attention kernel takes bf16/f16 q, k, v of one dtype, "
            f"not {q.dtype}/{k.dtype}/{v.dtype} (f32 inputs: ROADMAP "
            f"queue 2, K2)")
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"head dim {d} not compiled; have "
                                  f"{KERNEL_HEAD_DIMS}")
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
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bias = bias.contiguous() if bias is not None else None
    residual = residual.contiguous() if residual is not None else None
    out = torch.empty((b, sq, h, d), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out                  # an empty grid is not a launch
    lib = _lib()
    rc = lib.mma_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), KERNEL_DTYPES[q.dtype],
        _OUT_CODES[bias.dtype] if bias is not None else 0,
        _OUT_CODES[residual.dtype] if residual is not None else 0,
        _OUT_CODES[out_dtype], b, sq, sk, h, kvh, d, int(causal),
        int(q_offset), int(window or 0), float(d ** -0.5),
        _epilogue.ACT_CODES[ep.activation if ep is not None else None],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "mma_flash_attention")
    mma_flash_attention.launches += 1
    return out


mma_flash_attention.launches = 0
