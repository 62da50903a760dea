"""Convolutions: the wrappers of the Hopper kernels and their plain
versions (port of ``repro.kernels.mma_conv``, TPU kernels K3 and K4).

Both kernels are in ``csrc/mma_conv.cu``; its head comments say which TPU
kernel each replaces (``repro/kernels/mma_conv.py``: ``mma_conv2d`` and
``mma_depthwise_conv2d``), what bounds it on an H100 and what its design
does about that.

``mma_conv2d`` (K3) computes the VALID dense convolution

    out[n, oh, ow, f] = cast(epilogue(sum_{i, j, c} x[n, oh*sh + i, ow*sw + j, c]
                                                    * w[i, j, c, f]))

for image (N, H, W, C) and filters (KH, KW, C, F) as an implicit GEMM with
an fp32 accumulator; its plain version is ``ref.conv2d`` (the materialised
patch matrix times the (KH*KW*C, F) filter view) plus ``epilogue.apply``.
``mma_depthwise_conv2d`` (K4) computes the VALID depthwise (groups == C)
convolution

    out[n, oh, ow, c] = cast(epilogue(sum_{i, j} x[n, oh*sh + i, ow*sw + j, c]
                                                 * taps[i, j, c]))

for image (N, H, W, C) and taps (KH, KW, C); its plain version is the eager
shift-and-sum of ``ref.depthwise_conv`` plus ``epilogue.apply``.

Each wrapper takes its kernel's path up front from ``core.tiling``: K3's
``choose_conv_path`` ("wgmma" for bf16/f16 filter banks TMA can read over
images gathered in 16- or 4-byte copies, "wmma" for the rest or an explicit
filter tile, "f32" for F32GER; a tuned winner's filter tile where the conv
can take it, else, counted in ``mma_conv2d.tuned_fallbacks``, the
heuristic), K4's
``depthwise_plan`` (the vector path where 16 bytes of channels divide C at
16-byte bases, else the scalar one).  A CPU tensor goes to the plain
version, whatever the path.  A CUDA tensor launches the chosen kernel or
raises: there is no fallback.  Each wrapper's ``launches`` counts its
kernel's launches, ``launches_by_path`` the same by path (and
``mma_conv2d.packed_launches_by_path`` those on a packed filter stream),
and nothing else.

K3's packed filter stream (``core/packing.py``): ``mma_conv2d(...,
w_layout=...)`` takes the raw ``(gf, KH, KW, C, 64)`` stream of a
prepacked filter bank.  The call takes the path the natural filter would
take (:func:`conv_path`, chosen once) and hands the stream's pointer to
its kernel untouched: the wgmma kernel reads it through a 3-D tensor map,
the WMMA and fp32 tiles through ``tile_gemm.cuh``'s packed loader (the
WMMA tile's 128 filters two 64-filter slabs).  The result is the natural
launch's bit for bit.  On the CPU the plain version reads the stream as
the natural filter bank (``packing.conv_panels_filter``).

Gradients: where the image, the filters, the bias or the residual
requires one, each wrapper runs as a ``torch.autograd.Function``: the
forward is its kernel (or the plain version on the CPU), the backward
differentiates a recomputation through the torch conv lowering
(``core.lowering.torch_conv``; no TPU backward kernel exists, see
``kernels._autograd``) and launches nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing, precision, tiling
from repro_torch.kernels import _autograd, _build
from repro_torch.kernels import epilogue as _epilogue
from repro_torch.kernels import ref as _ref

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_CONV2D_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                    + [ctypes.c_int] * 9 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])

# The Ger family of each input dtype, and K3's paths as csrc/mma_conv.cu
# numbers them (CONV_PATH_*).
_GER = {torch.bfloat16: precision.Ger.BF16GER2,
        torch.float16: precision.Ger.F16GER2,
        torch.float32: precision.Ger.F32GER}
CONV_PATHS = {"wmma": 0, "f32": 1, "wgmma": 2}
DEPTHWISE_PATHS = ("vector", "scalar")

# The filter tiles (bf, K3's N tile) an explicit Plan.block may name, by
# input dtype: the WMMA tile (F32GER: the fp32 tiles); the F fringe of a
# narrower or ragged filter bank is masked.
CONV_TILE = {dt: tuple(t.bn for t in tiling.CONV_TILES[g])
             for dt, g in _GER.items()}


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
    for fn, argtypes in ((lib.mma_depthwise_conv_launch, _ARGTYPES),
                         (lib.mma_conv2d_launch, _CONV2D_ARGTYPES),
                         (lib.mma_conv2d_packed_launch, _CONV2D_ARGTYPES)):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _code(t):
    if t is None:
        return 0
    if t.dtype not in DTYPE_CODES:
        raise NotImplementedError(
            f"the conv kernels' epilogue operands are f32/bf16/f16, "
            f"not {t.dtype}")
    return DTYPE_CODES[t.dtype]


def _check_epilogue(ep, bias, residual, out_shape, f):
    """The effective epilogue (None for identity), its operands checked."""
    ep = ep if ep is not None and not ep.is_identity else None
    if ep is not None:
        ep.validate(torch.float32, bias=bias, residual=residual)
    elif bias is not None or residual is not None:
        raise ValueError("bias/residual operands need an Epilogue")
    for name, t, want in (("residual", residual, out_shape),
                          ("bias", bias, (f,))):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want {want}")
    return ep


class _ConvFn(torch.autograd.Function):
    """A conv kernel under autograd: the kernel forward (``dispatch``);
    the backward differentiates the torch conv lowering's
    recomputation."""

    @staticmethod
    def forward(ctx, image, filters, bias, residual, dispatch, opts):
        ctx.opts = opts
        ctx.res_dtype = residual.dtype if residual is not None else None
        ctx.save_for_backward(image, filters, bias)
        return dispatch(image, filters, bias=bias, residual=residual, **opts)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.core import lowering   # imports this module
        image, filters, bias = ctx.saved_tensors
        o = ctx.opts
        need = ctx.needs_input_grad

        def recomputed(image, filters, bias):
            out = lowering.torch_conv(image, filters, o["stride"],
                                      filters.ndim == 3, torch.float32)
            out = _epilogue.apply(out, _autograd.without_residual(o["ep"]),
                                  bias=bias)
            return out.to(dout.dtype)

        di, df, db = _autograd.recompute(
            recomputed, (image, filters, bias), (need[0], need[1], need[2]),
            dout)
        return (di, df, db,
                (dout.to(ctx.res_dtype) if need[3] else None), None,
                None)


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
    Differentiable where an operand requires a gradient (the module
    docstring says how).
    """
    opts = dict(stride=tuple(int(s) for s in stride), out_dtype=out_dtype,
                ep=ep)
    if _autograd.wants_grad(image, taps, bias, residual):
        return _ConvFn.apply(image, taps, bias, residual,
                             _mma_depthwise_conv2d, opts)
    return _mma_depthwise_conv2d(image, taps, bias=bias, residual=residual,
                                 **opts)


def _mma_depthwise_conv2d(image, taps, *, stride, out_dtype, ep, bias,
                          residual) -> torch.Tensor:
    """K4's dispatch: the plain version on a CPU tensor, the kernel on a
    CUDA tensor."""
    n, oh, ow, c = _geometry(image, taps, stride)
    out_shape = (n, oh, ow, c)
    ep = _check_epilogue(ep, bias, residual, out_shape, c)
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
    vec = tiling.depthwise_plan(
        c, image.dtype,
        image.data_ptr() % 16 == 0 and taps.data_ptr() % 16 == 0)
    lib = _lib()
    rc = lib.mma_depthwise_conv_launch(
        image.data_ptr(), taps.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        DTYPE_CODES[image.dtype], _code(bias), _code(residual),
        DTYPE_CODES[out_dtype],
        *image.shape, taps.shape[0], taps.shape[1], stride[0], stride[1],
        _epilogue.ACT_CODES[ep.activation if ep is not None else None],
        vec, torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(lib, rc, "mma_depthwise_conv2d")
    path = "vector" if vec else "scalar"
    mma_depthwise_conv2d.launches += 1
    mma_depthwise_conv2d.launches_by_path[path] += 1
    if mma_depthwise_conv2d.trace is not None:
        mma_depthwise_conv2d.trace.append(
            (tuple(image.shape), tuple(taps.shape[:2]), tuple(stride),
             image.dtype, out_dtype,
             ep.activation if ep is not None else None, bias is not None,
             residual is not None, path))
    return out


mma_depthwise_conv2d.launches = 0
mma_depthwise_conv2d.launches_by_path = dict.fromkeys(DEPTHWISE_PATHS, 0)
# A list to record (image shape, (KH, KW), stride, dtype, out dtype,
# activation, bias given, residual given, path) of each launch into, or
# None (chip_smoke.py).
mma_depthwise_conv2d.trace = None


# ----------------------------------------------------------------------
# K3: the dense convolution
# ----------------------------------------------------------------------

def _dense_geometry(image, kernels, stride, w_layout=None):
    if w_layout is not None:
        if w_layout.tile != "conv" or kernels.ndim != 5:
            raise ValueError(f"packed filter stream of rank {kernels.ndim} "
                             f"does not match layout {w_layout!r}")
        fshape = (w_layout.kh, w_layout.kw, w_layout.c, w_layout.f)
    elif kernels.ndim == 5:
        raise ValueError("a 5-D filter is a packed (gf, KH, KW, C, bf) "
                         "stream: pass its w_layout")
    else:
        fshape = tuple(kernels.shape)
    if image.ndim != 4 or len(fshape) != 4:
        raise ValueError(f"conv2d wants image (N, H, W, C) and filters "
                         f"(KH, KW, C, F); got {tuple(image.shape)} x "
                         f"{tuple(kernels.shape)}")
    n, h, w, c = image.shape
    kh, kw, c2, f = fshape
    if c != c2:
        raise ValueError(f"channel mismatch {tuple(image.shape)} vs "
                         f"{tuple(kernels.shape)}")
    sh, sw = stride
    if sh < 1 or sw < 1:
        raise ValueError(f"strides must be >= 1, got {stride!r}")
    if h < kh or w < kw:
        raise ValueError(f"image {tuple(image.shape)} is smaller than the "
                         f"filters {tuple(kernels.shape)} (VALID padding)")
    return n, (h - kh) // sh + 1, (w - kw) // sw + 1, f


def mma_conv2d_plain(image, kernels, *, stride=(1, 1),
                     out_dtype=torch.float32,
                     ep: _epilogue.Epilogue | None = None,
                     bias=None, residual=None):
    """The plain version: the materialised patch matrix times the filter
    view in fp32 (``ref.conv2d``), epilogue, cast."""
    out = _ref.conv2d(image, kernels, stride=tuple(stride))
    out = _epilogue.apply(out, ep, bias=bias, residual=residual)
    return out.to(out_dtype)


def mma_conv2d(image: torch.Tensor, kernels: torch.Tensor, *,
               bf: int | None = None, stride: tuple[int, int] = (1, 1),
               out_dtype: torch.dtype = torch.float32,
               ep: _epilogue.Epilogue | None = None,
               bias: torch.Tensor | None = None,
               residual: torch.Tensor | None = None,
               w_layout: packing.ConvLayout | None = None,
               tuned: tuple | None = None) -> torch.Tensor:
    """VALID 2-D convolution, stride (sh, sw) (the paper's h * A).

    image (N, H, W, C) and filters (KH, KW, C, F) of one dtype (f32, bf16
    or f16) -> (N, OH, OW, F) in ``out_dtype``; ``ep`` fuses bias (F,),
    activation and residual (N, OH, OW, F) into the single store.  ``bf``
    names the WMMA filter tile, which must be one of ``CONV_TILE`` of the
    input dtype; None lets ``core.tiling.choose_conv_path`` pick the
    kernel.  It changes no result beyond the order of the fp32 sums.  ``tuned`` is a
    GEMM winner's K3 counterpart (``tiling.conv_tuned``), taken where the
    conv can take it.  ``w_layout`` marks ``kernels`` as a packed filter
    stream (the module docstring).
    Differentiable where an operand requires a gradient (the module
    docstring says how), but for a packed filter stream.
    """
    opts = dict(bf=bf, stride=tuple(int(s) for s in stride),
                out_dtype=out_dtype, ep=ep, tuned=tuned)
    if w_layout is not None:
        if _autograd.wants_grad(image, kernels, bias, residual):
            raise NotImplementedError(
                "prepacked filters serve inference: a packed conv has no "
                "gradient")
        return _mma_conv2d(image, kernels, bias=bias, residual=residual,
                           w_layout=w_layout, **opts)
    if _autograd.wants_grad(image, kernels, bias, residual):
        return _ConvFn.apply(image, kernels, bias, residual, _mma_conv2d,
                             opts)
    return _mma_conv2d(image, kernels, bias=bias, residual=residual, **opts)


def conv_path(image, kh, kw, c, f, stride, bf, w_aligned, tuned=None):
    """(path, config) of K3 for this image and a (KH, KW, C, F) filter
    bank whose base is 16-byte aligned or not (``w_aligned``): the choice
    the natural dispatch makes, which a packed one follows."""
    n, h, w, _ = image.shape
    m = n * ((h - kh) // stride[0] + 1) * ((w - kw) // stride[1] + 1)
    return tiling.choose_conv_path(
        m, f, _GER[image.dtype], f % 8 == 0 and w_aligned,
        tiling.conv_gather_bytes(c, kw, w, stride[1],
                                 image.data_ptr()) > 0, bf, tuned)


def _mma_conv2d(image, kernels, *, bf, stride, out_dtype, ep, bias,
                residual, tuned, w_layout=None) -> torch.Tensor:
    """K3's dispatch: the plain version on a CPU tensor, the kernel on a
    CUDA tensor."""
    n, oh, ow, f = _dense_geometry(image, kernels, stride, w_layout)
    if image.dtype not in _GER or kernels.dtype != image.dtype:
        raise TypeError(f"the conv kernel takes image and filters of one "
                        f"dtype among f32/bf16/f16, got {image.dtype} x "
                        f"{kernels.dtype}")
    if tuned is not None and bf is not None:
        tuned = None                # an explicit filter tile wins
    if w_layout is not None:
        # the natural filter's path (a fresh, aligned allocation), chosen
        # once; every path reads the packed slabs
        kh, kw, c = w_layout.kh, w_layout.kw, w_layout.c
        path, cfg = conv_path(image, kh, kw, c, f, stride, bf, True, tuned)
        if w_layout.bf != packing.CONV_BF:
            raise ValueError(f"stale packed filter layout: bf = "
                             f"{w_layout.bf}, the kernels read "
                             f"{packing.CONV_BF} — repack "
                             f"(packing.refresh_conv)")
        if not kernels.is_contiguous() or kernels.data_ptr() % 16:
            raise ValueError("a packed filter stream must be contiguous and "
                             "16-byte aligned")
    else:
        kh, kw, c, _ = kernels.shape
        path, cfg = conv_path(image, kh, kw, c, f, stride, bf,
                              kernels.data_ptr() % 16 == 0, tuned)
    if tuned is not None and (path, cfg) != tuned:
        mma_conv2d.tuned_fallbacks += 1
    out_shape = (n, oh, ow, f)
    ep = _check_epilogue(ep, bias, residual, out_shape, f)
    if image.device.type == "cpu" and w_layout is not None:
        kernels = packing.conv_panels_filter(kernels, w_layout)
    if image.device.type == "cpu":
        return mma_conv2d_plain(image, kernels, stride=stride,
                                out_dtype=out_dtype, ep=ep, bias=bias,
                                residual=residual)
    if image.device.type != "cuda":
        raise ValueError(f"mma_conv2d runs on cuda (or its plain version on "
                         f"cpu), not {image.device}")
    if out_dtype not in DTYPE_CODES:
        raise NotImplementedError(f"the conv kernel stores f32/bf16/f16, "
                                  f"not {out_dtype}")
    for name, t in (("filters", kernels), ("bias", bias),
                    ("residual", residual)):
        if t is not None and t.device != image.device:
            raise ValueError(f"{name} on {t.device}, image on {image.device}")
    for name, t in (("image", image), ("filters", kernels), ("bias", bias),
                    ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"the conv kernel takes contiguous operands; "
                             f"{name} has strides {t.stride()}")
    out = torch.empty(out_shape, dtype=out_dtype, device=image.device)
    if out.numel() == 0:
        return out                  # an empty grid is not a launch
    lib = _lib()
    launch = (lib.mma_conv2d_launch if w_layout is None
              else lib.mma_conv2d_packed_launch)
    rc = launch(
        image.data_ptr(), kernels.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        DTYPE_CODES[image.dtype], _code(bias), _code(residual),
        DTYPE_CODES[out_dtype], *image.shape, kh, kw, f, stride[0], stride[1],
        _epilogue.ACT_CODES[ep.activation if ep is not None else None],
        CONV_PATHS[path], cfg.bn,
        torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(lib, rc, f"mma_conv2d ({path})")
    mma_conv2d.launches += 1
    mma_conv2d.launches_by_path[path] += 1
    if w_layout is not None:
        mma_conv2d.packed_launches_by_path[path] += 1
    return out


mma_conv2d.launches = 0
mma_conv2d.launches_by_path = dict.fromkeys(CONV_PATHS, 0)
# The launches on a packed filter stream (also in launches_by_path).
mma_conv2d.packed_launches_by_path = dict.fromkeys(CONV_PATHS, 0)
# The calls whose tuned filter tile the conv could not take, so that the
# heuristic ran (not launches: counted on the CPU too).
mma_conv2d.tuned_fallbacks = 0
