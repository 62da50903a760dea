"""Accumulator-resident GEMM: the wrapper of the Hopper kernels and their
plain versions (port of ``repro.kernels.mma_gemm``, TPU kernel K1a).

Three kernels compute it, one per regime, chosen by shape in
``core.tiling.choose_gemm_path``: ``csrc/gemm_stream.cu`` (M <= 64: a
split-K cp.async weight stream, bound by bytes), ``csrc/gemm_wgmma.cu``
(larger M: a TMA + wgmma tile, bound by the tensor cores) and
``csrc/mma_gemm.cu`` (WMMA tiles: unaligned pitches at large M, K < 16,
F32GER, an explicit block).  Each source's head comment says which TPU
kernel it replaces (``repro/kernels/mma_gemm.py``, ``mma_gemm``), what
bounds it on an H100 and what its design does about that.

``mma_gemm`` computes

    C <- cast(epilogue(alpha * ([-](X @ Y) [+ beta * (+/-)C])))

for x (M, K) or (B, M, K) and y (K, N) or (B, K, N) in the family's input
dtype.  A CPU tensor goes to the plain version of the path the card would
take: :func:`mma_gemm_splitk_plain` (fp32 partial products over the
weight stream's K slices, summed in split order) where that path splits K,
else :func:`mma_gemm_plain` (prime, one rank-K update, deprime).  A CUDA
tensor launches a kernel or raises: there is no fallback.
``mma_gemm.launches`` counts products computed on the card (one per call,
whatever the path or split), ``mma_gemm.launches_by_path`` the same by
path, and nothing else.
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
# csrc/gemm_stream.cu: gemm_stream_launch
_STREAM_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                    + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                    + [ctypes.c_int] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
# csrc/gemm_wgmma.cu: gemm_wgmma_launch
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_int] + [ctypes.c_void_p])
PATHS = ("stream", "wgmma", "wmma")


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


def mma_gemm_splitk_plain(x, y, c=None, *, kind: Ger,
                          k_slices: list[tuple[int, int]],
                          neg_product: bool = False, neg_acc: bool = False,
                          alpha: float = 1.0, beta: float = 1.0,
                          ep: _epilogue.Epilogue | None = None, bias=None,
                          residual=None, out_dtype=None):
    """The weight stream's arithmetic: one fp32 partial product per K
    slice (``tiling.StreamConfig.k_slices``), the partials summed in split
    order, then the seed, alpha and the epilogue once, as the last block
    of an N tile applies them."""
    pol = precision.policy(kind)
    acc = None
    for k0, k1 in k_slices:
        part = torch.matmul(x[..., k0:k1].to(pol.acc_dtype),
                            y[..., k0:k1, :].to(pol.acc_dtype))
        acc = part if acc is None else acc + part
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


_FNS: dict[str, tuple] = {}


def _lib(name: str, fn_name: str, argtypes):
    """(library, launcher) of ``csrc/<name>.cu``, typed once."""
    got = _FNS.get(name)
    if got is None:
        lib = _build.load(name)
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        got = _FNS[name] = (lib, fn)
    return got


def _is_aligned(*ts) -> bool:
    """16-byte bases and row pitches: TMA's rule for the wgmma path."""
    return all(t.data_ptr() % 16 == 0 and (t.shape[-1] * t.element_size())
               % 16 == 0 for t in ts)


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
        block = tuple(block)
        tiling.check_block(block, kind)
    forms = dict(neg_product=neg_product, neg_acc=neg_acc, alpha=alpha,
                 beta=beta, ep=ep, bias=bias, residual=residual,
                 out_dtype=out_dtype)
    if x.device.type == "cpu":
        path, cfg = tiling.choose_gemm_path(m, n, k, kind, b or 1,
                                            _is_aligned(x, y), block)
        if path == "stream" and cfg.split > 1:
            return mma_gemm_splitk_plain(x, y, c, kind=kind,
                                         k_slices=cfg.k_slices(k), **forms)
        return mma_gemm_plain(x, y, c, kind=kind, **forms)
    if x.device.type != "cuda":
        raise ValueError(f"mma_gemm runs on cuda (or its plain version on "
                         f"cpu), not {x.device}")
    if out_dtype not in DTYPE_CODES:
        raise NotImplementedError(f"the GEMM kernel stores f32/bf16/f16, "
                                  f"not {out_dtype}")
    if (b or 1) > 65535:
        raise ValueError(f"grid too large for one launch: b={b}")
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
    path, cfg = tiling.choose_gemm_path(m, n, k, kind, b or 1,
                                        _is_aligned(x, y), block)
    batched = b is not None
    common = (_ptr(c), _ptr(bias), _ptr(residual), out.data_ptr())
    codes = (_code(c), _code(bias), _code(residual), DTYPE_CODES[out_dtype])
    forms = (float(alpha), float(beta), int(neg_product), int(neg_acc),
             _epilogue.ACT_CODES[ep.activation if ep is not None else None])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if path == "stream":
        ws = tickets = None
        if cfg.split > 1:
            # One allocation per call, from the stream-ordered caching
            # allocator: the (B, split, M, N) fp32 partials, then one int32
            # ticket per (batch, N tile), which the launcher zeroes on the
            # stream before the kernel.
            parts = (b or 1) * cfg.split * m * n
            buf = torch.empty(parts + (b or 1) * cfg.grid(n)[0],
                              dtype=torch.float32, device=x.device)
            ws, tickets = buf.data_ptr(), buf.data_ptr() + 4 * parts
        lib, fn = _lib("gemm_stream", "gemm_stream_launch", _STREAM_ARGTYPES)
        rc = fn(x.data_ptr(), y.data_ptr(), *common, ws, tickets,
                DTYPE_CODES[x.dtype], *codes, b or 1, m, n, k, *forms,
                cfg.bn, cfg.split, stream)
    elif path == "wgmma":
        lib, fn = _lib("gemm_wgmma", "gemm_wgmma_launch", _WGMMA_ARGTYPES)
        rc = fn(x.data_ptr(), y.data_ptr(), *common, DTYPE_CODES[x.dtype],
                *codes, b or 1, int(batched), m, n, k, *forms, cfg.bn,
                stream)
    else:
        if -(-m // cfg.bm) > 65535:
            raise ValueError(f"grid too large for one launch: m={m}")
        lib, fn = _lib("mma_gemm", "mma_gemm_launch", _ARGTYPES)
        rc = fn(x.data_ptr(), y.data_ptr(), *common, DTYPE_CODES[x.dtype],
                *codes, b or 1, m, n, k,
                m * k if batched else 0, k * n if batched else 0,
                m * n, m * n, m * n, *forms, cfg.bm, cfg.bn, cfg.bk, stream)
    _build.check(lib, rc, f"mma_gemm ({path})")
    mma_gemm.launches += 1
    mma_gemm.launches_by_path[path] += 1
    if mma_gemm.trace is not None:
        mma_gemm.trace.append((b or 1, m, k, n, x.dtype, out_dtype, path))
    return out


mma_gemm.launches = 0
mma_gemm.launches_by_path = dict.fromkeys(PATHS, 0)
# A list to record (batch, M, K, N, dtype, out dtype, path) of each launch
# into, or None: chip_smoke.py times the shapes a run gave the kernels.
mma_gemm.trace = None
