"""Depthwise convolution: the wrapper of the Hopper kernel and its plain
version (port of ``repro.kernels.mma_conv``, TPU kernel K4).

The kernel is ``csrc/mma_conv.cu``; its head comment says which TPU kernel
it replaces (``repro/kernels/mma_conv.py``, ``mma_depthwise_conv2d``), what
bounds it on an H100 (device memory, and the launch at decode's L = 1) and
what its design does about that.  The dense ``mma_conv2d`` (K3) is not
ported yet (ROADMAP queue 2, K3; slice B2).

``mma_depthwise_conv2d`` computes the VALID depthwise (groups == C)
convolution

    out[n, oh, ow, c] = cast(epilogue(sum_{i, j} x[n, oh*sh + i, ow*sw + j, c]
                                                 * taps[i, j, c]))

for image (N, H, W, C) and taps (KH, KW, C), with an fp32 accumulator.  A
CPU tensor goes to :func:`mma_depthwise_conv2d_plain`, the eager
shift-and-sum of ``ref.depthwise_conv`` plus ``epilogue.apply``.  A CUDA
tensor launches the kernel or raises: there is no fallback.
``mma_depthwise_conv2d.launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as _epilogue
from repro_torch.kernels import ref as _ref

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_int] + [ctypes.c_void_p])


def _geometry(image, taps, stride):
    if image.ndim != 4 or taps.ndim != 3:
        raise ValueError(f"depthwise conv wants image (N, H, W, C) and taps "
                         f"(KH, KW, C); got {tuple(image.shape)} x "
                         f"{tuple(taps.shape)}")
    n, h, w, c = image.shape
    kh, kw, c2 = taps.shape
    if c != c2:
        raise ValueError(f"channel mismatch {tuple(image.shape)} vs "
                         f"{tuple(taps.shape)}")
    sh, sw = stride
    if sh < 1 or sw < 1:
        raise ValueError(f"strides must be >= 1, got {stride!r}")
    if h < kh or w < kw:
        raise ValueError(f"image {tuple(image.shape)} is smaller than the "
                         f"taps {tuple(taps.shape)} (VALID padding)")
    return n, (h - kh) // sh + 1, (w - kw) // sw + 1, c


def mma_depthwise_conv2d_plain(image, taps, *, stride=(1, 1),
                               out_dtype=torch.float32,
                               ep: _epilogue.Epilogue | None = None,
                               bias=None, residual=None):
    """The plain version: fp32 shift-and-sum, epilogue, cast."""
    out = _ref.depthwise_conv(image, taps, stride=tuple(stride),
                              acc_dtype=torch.float32)
    out = _epilogue.apply(out, ep, bias=bias, residual=residual)
    return out.to(out_dtype)


def _lib():
    lib = _build.load("mma_conv")
    fn = lib.mma_depthwise_conv_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _code(t):
    if t is None:
        return 0
    if t.dtype not in DTYPE_CODES:
        raise NotImplementedError(
            f"the depthwise kernel's epilogue operands are f32/bf16/f16, "
            f"not {t.dtype}")
    return DTYPE_CODES[t.dtype]


def mma_depthwise_conv2d(image: torch.Tensor, taps: torch.Tensor, *,
                         stride: tuple[int, int] = (1, 1),
                         out_dtype: torch.dtype = torch.float32,
                         ep: _epilogue.Epilogue | None = None,
                         bias: torch.Tensor | None = None,
                         residual: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """VALID depthwise (groups == C) convolution, stride (sh, sw).

    image (N, H, W, C) and taps (KH, KW, C) of one dtype (f32, bf16 or
    f16) -> (N, OH, OW, C) in ``out_dtype``; ``ep`` fuses bias (C,),
    activation and residual (N, OH, OW, C) into the single store.
    """
    stride = tuple(int(s) for s in stride)
    n, oh, ow, c = _geometry(image, taps, stride)
    ep = ep if ep is not None and not ep.is_identity else None
    if ep is not None:
        ep.validate(torch.float32, bias=bias, residual=residual)
    elif bias is not None or residual is not None:
        raise ValueError("bias/residual operands need an Epilogue")
    out_shape = (n, oh, ow, c)
    for name, t, want in (("residual", residual, out_shape),
                          ("bias", bias, (c,))):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want {want}")
    if image.device.type == "cpu":
        return mma_depthwise_conv2d_plain(
            image, taps, stride=stride, out_dtype=out_dtype, ep=ep,
            bias=bias, residual=residual)
    if image.device.type != "cuda":
        raise ValueError(f"mma_depthwise_conv2d runs on cuda (or its plain "
                         f"version on cpu), not {image.device}")
    if image.dtype not in DTYPE_CODES or taps.dtype != image.dtype:
        raise TypeError(f"the depthwise kernel takes image and taps of one "
                        f"dtype among f32/bf16/f16, got {image.dtype} x "
                        f"{taps.dtype}")
    if out_dtype not in DTYPE_CODES:
        raise NotImplementedError(f"the depthwise kernel stores f32/bf16/f16,"
                                  f" not {out_dtype}")
    for t in (taps, bias, residual):
        if t is not None and t.device != image.device:
            raise ValueError(f"operands on {image.device} and {t.device}")
    image, taps = image.contiguous(), taps.contiguous()
    bias = bias.contiguous() if bias is not None else None
    residual = residual.contiguous() if residual is not None else None
    out = torch.empty(out_shape, dtype=out_dtype, device=image.device)
    if out.numel() == 0:
        return out                  # an empty grid is not a launch
    lib = _lib()
    rc = lib.mma_depthwise_conv_launch(
        image.data_ptr(), taps.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        DTYPE_CODES[image.dtype], _code(bias), _code(residual),
        DTYPE_CODES[out_dtype],
        *image.shape, taps.shape[0], taps.shape[1], stride[0], stride[1],
        _epilogue.ACT_CODES[ep.activation if ep is not None else None],
        torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(lib, rc, "mma_depthwise_conv2d")
    mma_depthwise_conv2d.launches += 1
    return out


mma_depthwise_conv2d.launches = 0
