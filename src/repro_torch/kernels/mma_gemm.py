"""Accumulator-resident GEMM: the wrapper of the Hopper kernel and its plain
version (port of ``repro.kernels.mma_gemm``, TPU kernel K1a).

The kernel is ``csrc/mma_gemm.cu``; its head comment says which TPU kernel
it replaces (``repro/kernels/mma_gemm.py``, ``mma_gemm``), what bounds it on
an H100 (device memory for decode's skinny products, the bf16 tensor cores
for prefill's) and what its design does about that.

``mma_gemm`` computes

    C <- cast(epilogue(alpha * ([-](X @ Y) [+ beta * (+/-)C])))

for x (M, K) or (B, M, K) and y (K, N) or (B, K, N) in the family's input
dtype.  A CPU tensor goes to :func:`mma_gemm_plain`, the same accumulator
lifecycle in eager torch (prime, rank-K update, deprime).  A CUDA tensor
launches the kernel or raises: there is no fallback.  ``mma_gemm.launches``
counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import precision, tiling
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as _epilogue

Ger = precision.Ger

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 5 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _shapes(x, y):
    if x.ndim not in (2, 3) or y.ndim != x.ndim:
        raise ValueError(f"mma_gemm wants (M, K) x (K, N) or (B, M, K) x "
                         f"(B, K, N); got {tuple(x.shape)} x {tuple(y.shape)}")
    m, k = x.shape[-2:]
    k2, n = y.shape[-2:]
    if k != k2 or (x.ndim == 3 and x.shape[0] != y.shape[0]):
        raise ValueError(f"shape mismatch x{tuple(x.shape)} @ "
                         f"y{tuple(y.shape)}")
    return (x.shape[0] if x.ndim == 3 else None), m, n, k


def mma_gemm_plain(x, y, c=None, *, kind: Ger, neg_product: bool = False,
                   neg_acc: bool = False, alpha: float = 1.0,
                   beta: float = 1.0, ep: _epilogue.Epilogue | None = None,
                   bias=None, residual=None, out_dtype=None):
    """The plain version: prime -> one rank-K update -> deprime, in the
    family's accumulator dtype (bf16/f16 products are exact in fp32)."""
    pol = precision.policy(kind)
    acc = torch.matmul(x.to(pol.acc_dtype), y.to(pol.acc_dtype))
    if neg_product:
        acc = -acc
    if c is not None:
        seed = c.to(pol.acc_dtype)
        if beta != 1.0:
            seed = seed * beta
        acc = acc + (-seed if neg_acc else seed)
    if alpha != 1.0:
        acc = acc * alpha
    out = _epilogue.apply(acc, ep, bias=bias, residual=residual)
    return out.to(out_dtype or pol.acc_dtype)


def _lib():
    lib = _build.load("mma_gemm")
    fn = lib.mma_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _code(t):
    if t is None:
        return 0
    if t.dtype not in DTYPE_CODES:
        raise NotImplementedError(
            f"the GEMM kernel's epilogue operands are f32/bf16/f16, "
            f"not {t.dtype}")
    return DTYPE_CODES[t.dtype]


def mma_gemm(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor | None = None,
             *, kind: Ger = Ger.BF16GER2,
             block: tuple[int, int, int] | None = None,
             neg_product: bool = False, neg_acc: bool = False,
             alpha: float = 1.0, beta: float = 1.0,
             ep: _epilogue.Epilogue | None = None,
             bias: torch.Tensor | None = None,
             residual: torch.Tensor | None = None,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C <- alpha * [-](X @ Y) [+ beta * (+/-)C] with a resident accumulator.

    ``c`` is the optional ((B,) M, N) accumulator seed (the pp/np/pn/nn
    forms); ``ep`` fuses bias (N,), activation and residual ((B,) M, N)
    into the single store; ``block`` picks one of the compiled tiles
    (``core.tiling.GEMM_TILES``) instead of ``choose_blocks``.
    """
    pol = precision.policy(kind)
    if kind == Ger.F32GER_3XBF16:
        raise ValueError(
            "F32GER_3XBF16 is a registered expansion hook — lower it "
            "through facility.contract (core/lowering.py), which chains "
            "three BF16GER2 kernel passes over one accumulator")
    b, m, n, k = _shapes(x, y)
    if x.dtype != pol.x_dtype or y.dtype != pol.y_dtype:
        raise TypeError(f"{kind.value} operands must arrive as "
                        f"{pol.x_dtype} x {pol.y_dtype}, got "
                        f"{x.dtype} x {y.dtype}")
    out_dtype = out_dtype or pol.acc_dtype
    ep = ep if ep is not None and not ep.is_identity else None
    if ep is not None:
        ep.validate(pol.acc_dtype, bias=bias, residual=residual)
    elif bias is not None or residual is not None:
        raise ValueError("bias/residual operands need an Epilogue")
    out_shape = (m, n) if b is None else (b, m, n)
    for name, t, want in (("c", c, out_shape), ("residual", residual,
                                                 out_shape),
                          ("bias", bias, (n,))):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want {want}")
    if block is not None:
        tiling.check_block(block, kind)
    if x.device.type == "cpu":
        return mma_gemm_plain(x, y, c, kind=kind, neg_product=neg_product,
                              neg_acc=neg_acc, alpha=alpha, beta=beta, ep=ep,
                              bias=bias, residual=residual,
                              out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mma_gemm runs on cuda (or its plain version on "
                         f"cpu), not {x.device}")
    if out_dtype not in DTYPE_CODES:
        raise NotImplementedError(f"the GEMM kernel stores f32/bf16/f16, "
                                  f"not {out_dtype}")
    cfg = (tiling.choose_blocks(m, n, k, kind, b or 1) if block is None
           else tiling.BlockConfig(*block))
    if (b or 1) > 65535 or -(-m // cfg.bm) > 65535:
        raise ValueError(f"grid too large for one launch: b={b}, m={m}")
    for t in (y, c, bias, residual):
        if t is not None and t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
    x, y = x.contiguous(), y.contiguous()
    c = c.contiguous() if c is not None else None
    bias = bias.contiguous() if bias is not None else None
    residual = residual.contiguous() if residual is not None else None
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out                  # an empty grid is not a launch
    batched = b is not None
    lib = _lib()
    rc = lib.mma_gemm_launch(
        x.data_ptr(), y.data_ptr(), _ptr(c), _ptr(bias), _ptr(residual),
        out.data_ptr(),
        DTYPE_CODES[x.dtype], _code(c), _code(bias), _code(residual),
        DTYPE_CODES[out_dtype],
        b or 1, m, n, k,
        m * k if batched else 0, k * n if batched else 0,
        m * n, m * n, m * n,
        float(alpha), float(beta), int(neg_product), int(neg_acc),
        _epilogue.ACT_CODES[ep.activation if ep is not None else None],
        cfg.bm, cfg.bn, cfg.bk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "mma_gemm")
    mma_gemm.launches += 1
    return out


mma_gemm.launches = 0
