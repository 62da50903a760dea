"""Accumulator-resident GEMM: the wrapper of the Hopper kernels and their
plain versions (port of ``repro.kernels.mma_gemm``, TPU kernel K1).

Five kernels compute it, chosen in ``core.tiling.choose_gemm_path`` (an
explicit block, else a tuned winner the call can take, else the shape
heuristic; ``core/autotune.py``).  The 16-bit and fp32 families take one
of three by shape:
``csrc/gemm_stream.cu`` (M <= 64: a split-K weight stream, bound by
bytes: bf16/f16 on a TMA producer in work units sized to the card, rows
TMA cannot read on a cp.async ring; F32GER's on true fp32 FMAs),
``csrc/gemm_wgmma.cu`` (larger
16-bit M: a TMA + wgmma tile, bound by the tensor cores) and
``csrc/mma_gemm.cu`` (WMMA tiles: unaligned pitches at large M, K < 16,
an explicit block; F32GER at M > 64 on its fp32 SIMT tiles).  The integer families
(I8GER4, I4GER8, I16GER2) run ``csrc/gemm_imma.cu`` on the int8 tensor
cores and F64GER runs ``csrc/gemm_dmma.cu`` on the fp64 tensor cores.
Each source's head comment says which TPU kernel it replaces
(``repro/kernels/mma_gemm.py``, ``mma_gemm``), what bounds it on an H100
and what its design does about that.  ``tuned`` hands the wrapper an
autotune winner, a (path, config) pair (``core.lowering.resolve_block``
reads it from the cache); where the call cannot take it (a wgmma tile met
by an unaligned pitch, the weight stream met by a masked call) the
heuristic runs, counted in ``mma_gemm.tuned_fallbacks``: the only silent
path change, and never a change of kernel family.

``mma_gemm`` computes

    C <- cast(epilogue(alpha * ([-](X @ Y) [+ beta * (+/-)C])))

for x (M, K) or (B, M, K) and y (K, N) or (B, K, N) in the family's input
dtype (I4GER8: both packed two nibbles a byte along K, x (M, K/2) and y
(K/2, N)).  An integer family accumulates in int32 and wraps modulo 2**32,
with alpha and beta truncated to integers, as the reference's int32
accumulator does; its seed, bias and residual are cast to int32, F64GER's
to float64, as the reference casts them to the accumulator dtype.  A CPU
tensor goes to the plain version of the path the card would take:
:func:`mma_gemm_splitk_plain` (fp32 partial products over the weight
stream's K slices, summed in split order) where that path splits K, else
:func:`mma_gemm_plain` (prime, one rank-K update, deprime).  A CUDA tensor
launches a kernel or raises: there is no fallback.  ``mma_gemm.launches``
counts products computed on the card (one per call, whatever the path or
split), ``mma_gemm.launches_by_path`` the same by path,
``mma_gemm.packed_launches_by_path`` those of them that read packed
panels, ``mma_gemm.masked_launches_by_path`` those that applied pm*
predicates, ``mma_gemm.checksum_launches_by_path`` those that took the ABFT
sidecar, and nothing else.

The ABFT checksum sidecar (K1e, ``core/abft.py``): ``checksum=True``
returns ``(out, ck_col, ck_row)``, where ``ck_col`` ((B,) gm, N) holds each
output tile's column sums and ``ck_row`` ((B,) M, gn) its row sums, gm x gn
being the tile grid of the path the call took (:func:`sidecar_tile`: the
weight stream's tile is all M rows by its bn columns, the wgmma tile 128 by
bn, the WMMA and DMMA tiles their (bm, bn)).  Each tile is summed in the
accumulator dtype after alpha, the seed and the epilogue and before the
cast, its M/N fringe lanes left out, by the kernel in its store: the stream
kernel from its staged fp32 tile (with K split, the last block of an N tile
to arrive, after it has reduced the partials), the wgmma tile from the
fp32 tile its epilogue stages, the WMMA/fp32 tiles from the
``store_matrix_sync`` staging and the DMMA kernel from its fp64 deprime
tile; each sum is one thread's or one warp's in a fixed order (no float
atomics), so it does not change from run to run.  ``out`` is the
``checksum=False`` output bit for bit.  The plain versions compute the
same vectors from their finished result (:func:`checksum_tiles`).  The
integer families (IMMA) and masked products take no sidecar: ABFT does not
verify them (``abft.plan_for``), and they raise NotImplementedError.

The pm* prefixed masked forms (K1b, paper eq. 3): ``masks=(xmask, ymask,
pmask)``, bool or uint8 tensors of shapes (M,), (N,) and (K,) (logical K)
on the operands' device, each optional and shared across the batch axis.
A masked call takes a static route (``choose_gemm_path(masked=True)``):
the WMMA tile for the 16-bit families and F32GER at every M, IMMA for the
integer families, DMMA for F64GER.  Each of those kernels applies the
predicates while it stages a panel into shared memory: a disabled row of
X, column of Y or rank (both panels' k-slice) is written as 0 through the
branch that zero-fills the M, N and K fringes, never multiplied, so a NaN
there gives exact zeros; the operands in HBM are never pre-masked.  The
plain versions select (``torch.where``) the same lanes.  I4GER8 takes a
column mask only (its X and rank predicates go through ``ref.pm_ger``, as
the reference's kernel refuses them), packed panels are read by every
masked loader (WMMA, fp32, IMMA and DMMA), and a masked product has no
gradient (NotImplementedError: nor has the reference's Pallas kernel).

Prepacked operands (K1d, ``core/packing.py``): ``y_layout`` marks y as the
raw Y-side panel tensor ``(gn, gk, 64, 64)`` (``(B, gn, gk, 64, 64)`` for
an expert bank) and ``x_layout`` marks x as the raw X-side ``(gm, gk, 128,
64)`` panels, either or both, in every family but I4GER8 (whose nibbles
keep their own packing, as the reference refuses packed int4).  Every
path reads them, masked or not, with or without the sidecar: the weight
stream, the wgmma tile, the WMMA and fp32 tiles, IMMA (I8GER4, I16GER2)
and DMMA (F64GER).  The call takes the path its natural operands would
take (``choose_gemm_path``, chosen once, a packed operand counting with
its natural pitch: :func:`natural_aligned`), checks the panel size (a
stale layout raises: ``packing.refresh_gemm`` repacks first) and hands the
panels' pointer to the kernel untouched.  The panels are zero-padded past
M, K and N, where the kernels read zeros anyway, so the result is the
natural launch's bit for bit.  A packed operand without a batch axis
beside a batched operand is shared across the batch (its batch stride is
0), as the reference's index map ignores the batch coordinate for it; a
natural operand must carry the batch axis of a batched call.  On the CPU
the plain version of the path reads the panels as the kernel-facing matrix
(``packing.gemm_panels_matrix``).  Packed operands serve inference: with
an operand that requires a gradient the call raises.

Gradients: where an operand requires one, ``mma_gemm`` runs as a
``torch.autograd.Function`` whose forward is the same dispatch and whose
backward is more products through this wrapper (the reference has no
backward kernel: its Pallas GEMM cannot be differentiated, and it trains
on XLA's products): dX = alpha (+/-) dZ Y^T and dY = alpha (+/-) X^T dZ
in the forward's family (dZ cast to its input dtype, accumulation in the
family's accumulator dtype), dC = alpha beta (+/-) dZ for the seed, dbias
the row sum of dZ and dresidual = dOut.  Under a fused activation Z is not
stored: one more product with the bias epilogue only and an
accumulator-dtype store recomputes it, and dZ = dOut act'(Z).  The
backward's operands X^T and Y^T are contiguous copies (the kernels read
row-major operands).  The integer families have no gradient (TypeError).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import packing, precision, tiling
from repro_torch.kernels import _autograd, _build
from repro_torch.kernels import epilogue as _epilogue
from repro_torch.kernels import ref as _ref

Ger = precision.Ger

# dtype codes of csrc/common.cuh: the 16-bit/fp32 kernels' operands and
# outputs; the IMMA and DMMA kernels also store int32 and float64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
STORE_CODES = {**DTYPE_CODES, torch.int32: 3, torch.float64: 4}

# The 16-bit/fp32 and DMMA launchers' checksum sidecar (ck_col, ck_row)
# pointers (null: no sidecar) and stream.  Every launcher ends with
# `panels`, which operands are packed panels (csrc/common.cuh: PANELS_X =
# 1, PANELS_Y = 2; 0: natural rows), and the weight stream and the wgmma
# tile then take each operand's batch stride in elements (0: shared).
_CK_STREAM = [ctypes.c_void_p] * 3
_PANELS_STRIDES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
# csrc/mma_gemm.cu: mma_gemm_launch (x, y, three masks, c, bias, res, out)
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 5 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_int] * 3 + _CK_STREAM
             + [ctypes.c_int])
# csrc/gemm_stream.cu: gemm_stream_launch
_STREAM_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                    + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                    + [ctypes.c_int] * 3 + [ctypes.c_int] * 3 + _CK_STREAM
                    + _PANELS_STRIDES)
# csrc/gemm_wgmma.cu: gemm_wgmma_launch
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_int] + _CK_STREAM
                   + _PANELS_STRIDES)
# csrc/gemm_imma.cu: gemm_imma_launch
_IMMA_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                  + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p] + [ctypes.c_int])
# csrc/gemm_dmma.cu: gemm_dmma_launch (its tile's bm, bn, bk before the
# sidecar)
_DMMA_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                  + [ctypes.c_longlong] * 5 + [ctypes.c_double] * 2
                  + [ctypes.c_int] * 3 + [ctypes.c_int] * 3 + _CK_STREAM
                  + [ctypes.c_int])
PATHS = ("stream", "wgmma", "wmma", "imma", "dmma")
PACKED_PATHS = PATHS                             # every path reads panels
MASKED_PATHS = ("wmma", "imma", "dmma")          # the paths that take masks
SIDECAR_PATHS = ("stream", "wgmma", "wmma", "dmma")   # checksum=True (K1e)


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


def select_masks(x, y, masks):
    """x (..., M, K) and y (..., K, N) with the pm* predicates applied as
    the kernels apply them: disabled rows of x, columns of y and ranks
    (both operands' k-slice) selected to exact zeros, never multiplied;
    the 1-D masks right-align over any leading batch axes (the plain
    versions, and the torch and ref masked lowerings).  I4GER8's y is
    masked by column only (its zero bytes unpack to zero nibbles)."""
    if masks is None:
        return x, y
    xm, ym, pm = (None if t is None else t.to(torch.bool) for t in masks)
    if xm is not None:
        x = torch.where(xm[:, None], x, torch.zeros_like(x))
    if pm is not None:
        x = torch.where(pm, x, torch.zeros_like(x))
        y = torch.where(pm[:, None], y, torch.zeros_like(y))
    if ym is not None:
        y = torch.where(ym, y, torch.zeros_like(y))
    return x, y


def mma_gemm_plain(x, y, c=None, *, kind: Ger, neg_product: bool = False,
                   neg_acc: bool = False, alpha: float = 1.0,
                   beta: float = 1.0, ep: _epilogue.Epilogue | None = None,
                   bias=None, residual=None, out_dtype=None, masks=None):
    """The plain version: prime -> one rank-K update -> deprime, in the
    family's accumulator dtype (bf16/f16 products are exact in fp32;
    integer ones exact, then wrapped to int32: ``ref.product``), on the
    operands with ``masks`` selected (:func:`select_masks`)."""
    pol = precision.policy(kind)
    x, y = select_masks(x, y, masks)
    acc = _ref.product(x, y, pol)
    if neg_product:
        acc = -acc
    if c is not None:
        seed = c.to(pol.acc_dtype)
        if beta != 1.0:
            seed = seed * acc_scalar(beta, pol)
        acc = acc + (-seed if neg_acc else seed)
    if alpha != 1.0:
        acc = acc * acc_scalar(alpha, pol)
    out = _epilogue.apply(acc, ep, bias=bias, residual=residual)
    return out.to(out_dtype or pol.acc_dtype)


def acc_scalar(v: float, pol: precision.GerPolicy):
    """alpha or beta in the accumulator's dtype: an integer accumulator
    truncates it toward zero (1.5 acts as 1), as the reference's
    ``jnp.asarray(alpha, int32)`` does."""
    return int(v) if pol.is_integer else v


def mma_gemm_splitk_plain(x, y, c=None, *, kind: Ger,
                          k_slices: list[tuple[int, int]],
                          neg_product: bool = False, neg_acc: bool = False,
                          alpha: float = 1.0, beta: float = 1.0,
                          ep: _epilogue.Epilogue | None = None, bias=None,
                          residual=None, out_dtype=None, masks=None):
    """The weight stream's arithmetic: one fp32 partial product per K
    slice (``tiling.StreamConfig.k_slices``), the partials summed in split
    order, then the seed, alpha and the epilogue once, as the last block
    of an N tile applies them; ``masks`` selected as in
    :func:`mma_gemm_plain`."""
    pol = precision.policy(kind)
    x, y = select_masks(x, y, masks)
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


def sidecar_tile(path: str, cfg, m: int) -> tuple[int, int]:
    """(rows, columns) of the output tile whose sums ``path``'s kernel
    takes: the weight stream's one tile of all M rows by its bn columns,
    else the path's (bm, bn)."""
    if path == "stream":
        return max(m, 1), cfg.bn
    return cfg.bm, cfg.bn


def checksum_tiles(fin: torch.Tensor, bm: int, bn: int):
    """The sidecar of a finished accumulator-dtype result ((B,) M, N), as
    the kernels take it: ``ck_col`` ((B,) gm, N), the column sums of each
    bm-row band, and ``ck_row`` ((B,) M, gn), the row sums of each bn-column
    band (the fringes past M and N padded with zeros)."""
    m, n = fin.shape[-2:]
    gm, gn = -(-m // bm), -(-n // bn)
    lead = tuple(fin.shape[:-2])
    padded = torch.nn.functional.pad(fin, (0, gn * bn - n, 0, gm * bm - m))
    ck_col = padded.reshape(lead + (gm, bm, gn * bn)).sum(-2)[..., :n]
    ck_row = padded.reshape(lead + (gm * bm, gn, bn)).sum(-1)[..., :m, :]
    return ck_col, ck_row


def _plain_of(path: str, cfg, k: int):
    """The plain version of ``path``'s arithmetic: the weight stream's
    split-K sum where it splits K, else prime, one update, deprime."""
    if path == "stream" and cfg.split > 1:
        return functools.partial(mma_gemm_splitk_plain,
                                 k_slices=cfg.k_slices(k))
    return mma_gemm_plain


def mma_gemm_sidecar_plain(x, y, c=None, *, kind: Ger, **forms):
    """``(finished, ck_col, ck_row)`` of a natural, unmasked call, on the
    operands' own device: the plain version of the path the call takes,
    its result in the accumulator dtype before the cast, and that result's
    sidecar (:func:`checksum_tiles`) — what the kernels' ``checksum=True``
    is held against on the card."""
    b, m, n, k = _shapes(x, y)
    path, cfg = tiling.choose_gemm_path(m, n, k, kind, b or 1,
                                        natural_aligned(x, y))
    fin = _plain_of(path, cfg, k)(
        x, y, c, kind=kind,
        **{**forms, "out_dtype": precision.policy(kind).acc_dtype})
    return (fin, *checksum_tiles(fin, *sidecar_tile(path, cfg, m)))


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


def natural_aligned(x, y, x_layout=None, y_layout=None) -> bool:
    """TMA's rule for the wgmma path (16-byte bases and row pitches) on the
    operands as the natural dispatch sees them after its ``.contiguous()``:
    a tensor that is not contiguous would be copied into a fresh, aligned
    allocation; a packed operand (its panels, with its layout) counts with
    its natural kernel-facing pitch, its natural tensor being such an
    allocation."""
    def ok(t, lay):
        pitch = (lay.cols if lay is not None else t.shape[-1]) \
            * t.element_size()
        base = (lay is not None or not t.is_contiguous()
                or t.data_ptr() % 16 == 0)
        return base and pitch % 16 == 0
    return ok(x, x_layout) and ok(y, y_layout)


def _packed_shapes(x, y, x_layout, y_layout):
    """(b, m, n, k) of a call with packed operands, their ranks checked.
    A packed operand without a batch axis may meet a batched operand: it
    is shared across the batch (the reference's ``batched`` rule); a
    natural operand must then carry the batch axis."""
    def dims(t, lay, natural_rank_of):
        if lay is None:
            if t.ndim not in (2, 3):
                raise ValueError(f"mma_gemm wants (M, K) x (K, N) or "
                                 f"batched operands; got {tuple(t.shape)}")
            return (t.shape[0] if t.ndim == 3 else None), *t.shape[-2:]
        if lay.tile != "gemm" or t.ndim != 4 + int(lay.batched):
            raise ValueError(f"packed operand of rank {t.ndim} does not "
                             f"match layout {lay!r}")
        if lay.side != natural_rank_of:
            raise ValueError(f"a {lay.side}-side layout passed as the "
                             f"{natural_rank_of} operand")
        return (t.shape[0] if lay.batched else None), lay.rows, lay.cols
    bx, m, k = dims(x, x_layout, "x")
    by, k2, n = dims(y, y_layout, "y")
    if k != k2 or (bx is not None and by is not None and bx != by):
        raise ValueError(f"shape mismatch x{(bx, m, k)} @ y{(by, k2, n)}")
    b = bx if bx is not None else by
    for side, own, lay in (("x", bx, x_layout), ("y", by, y_layout)):
        if b is not None and own is None and lay is None:
            raise ValueError(f"a batched operand needs a batched natural "
                             f"{side}: got x{(bx, m, k)} @ y{(by, k2, n)}")
    return b, m, n, k


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
             out_dtype: torch.dtype | None = None,
             x_layout: packing.GemmLayout | None = None,
             y_layout: packing.GemmLayout | None = None,
             masks: tuple | None = None, checksum: bool = False,
             tuned: tuple | None = None):
    """C <- alpha * [-](X @ Y) [+ beta * (+/-)C] with a resident accumulator.

    ``c`` is the optional ((B,) M, N) accumulator seed (the pp/np/pn/nn
    forms); ``ep`` fuses bias (N,), activation and residual ((B,) M, N)
    into the single store; ``block`` picks one of the compiled tiles
    (``core.tiling.GEMM_TILES``) instead of ``choose_blocks``.
    ``x_layout``/``y_layout`` mark x/y as raw packed panels (the module
    docstring says which paths read them).  ``masks`` is the pm* 3-tuple
    ``(xmask (M,), ymask (N,), pmask (K,))`` (the module docstring says
    where it runs).  Where an operand requires a gradient the call is
    differentiable (the module docstring says how), unless it is masked.
    ``checksum`` adds the ABFT sidecar: the call returns ``(out, ck_col,
    ck_row)`` (the module docstring says what they hold).  ``tuned`` is an
    autotune winner (path, config) (the module docstring says when it
    runs).
    """
    opts = dict(kind=kind, block=block, neg_product=neg_product,
                neg_acc=neg_acc, alpha=alpha, beta=beta, ep=ep,
                out_dtype=out_dtype, tuned=tuned)
    if checksum:
        if masks is not None and any(t is not None for t in masks):
            raise NotImplementedError(
                "a masked (pm*) product takes no checksum sidecar: ABFT "
                "does not verify the masked forms")
        if _autograd.wants_grad(x, y, c, bias, residual):
            raise NotImplementedError(
                "the checksum sidecar verifies served products: a product "
                "with a gradient takes none")
        return _mma_gemm(x, y, c, bias=bias, residual=residual,
                         x_layout=x_layout, y_layout=y_layout,
                         checksum=True, **opts)
    if masks is not None and any(t is not None for t in masks):
        if _autograd.wants_grad(x, y, c, bias, residual):
            raise NotImplementedError(
                "a masked (pm*) product has no gradient: the reference's "
                "Pallas kernel has none either; differentiate the torch "
                "lowering (backend='torch')")
        return _mma_gemm(x, y, c, bias=bias, residual=residual,
                         x_layout=x_layout, y_layout=y_layout, masks=masks,
                         **opts)
    if x_layout is not None or y_layout is not None:
        if _autograd.wants_grad(x, y, c, bias, residual):
            raise NotImplementedError(
                "prepacked operands serve inference: a packed product has "
                "no gradient")
        return _mma_gemm(x, y, c, bias=bias, residual=residual,
                         x_layout=x_layout, y_layout=y_layout, **opts)
    if _autograd.wants_grad(x, y, c, bias, residual):
        if precision.policy(kind).is_integer:
            raise TypeError(f"{kind.value} is an integer family: its "
                            f"products have no gradient")
        return _MmaGemmFn.apply(x, y, c, bias, residual, opts)
    return _mma_gemm(x, y, c, bias=bias, residual=residual, **opts)


class _MmaGemmFn(torch.autograd.Function):
    """The GEMM under autograd: the forward is the wrapper's dispatch, the
    backward more products through the wrapper (module docstring)."""

    @staticmethod
    def forward(ctx, x, y, c, bias, residual, opts):
        ep = opts["ep"]
        act = ep.activation if ep is not None else None
        ctx.opts, ctx.act = opts, act
        ctx.dtypes = tuple(t.dtype if t is not None else None
                           for t in (x, y, c, bias, residual))
        # the seed and bias are needed again only to recompute Z
        ctx.save_for_backward(x, y, c if act else None,
                              bias if act else None)
        return _mma_gemm(x, y, c, bias=bias, residual=residual, **opts)

    @staticmethod
    def backward(ctx, dout):
        x, y, c, bias = ctx.saved_tensors
        o = ctx.opts
        pol = precision.policy(o["kind"])
        need = ctx.needs_input_grad
        if ctx.act is not None:
            z = _mma_gemm(x, y, c, kind=o["kind"], block=o["block"],
                          tuned=o["tuned"],
                          neg_product=o["neg_product"], neg_acc=o["neg_acc"],
                          alpha=o["alpha"], beta=o["beta"],
                          ep=_epilogue.Epilogue(bias=bias is not None),
                          bias=bias, out_dtype=pol.acc_dtype)
            with torch.enable_grad():
                z.requires_grad_(True)
                a = _epilogue.ACTIVATIONS[ctx.act](z)
            dz, = torch.autograd.grad(a, z, dout.to(pol.acc_dtype))
        else:
            dz = dout
        grads = [None] * 5
        prod = dict(kind=o["kind"], neg_product=o["neg_product"],
                    alpha=o["alpha"])
        if need[0]:
            grads[0] = _mma_gemm(dz.to(pol.x_dtype), y.transpose(-1, -2),
                                 out_dtype=ctx.dtypes[0], **prod)
        if need[1]:
            grads[1] = _mma_gemm(x.transpose(-1, -2), dz.to(pol.y_dtype),
                                 out_dtype=ctx.dtypes[1], **prod)
        if need[2]:
            s = o["alpha"] * o["beta"] * (-1.0 if o["neg_acc"] else 1.0)
            grads[2] = (dz.to(pol.acc_dtype) * s).to(ctx.dtypes[2])
        if need[3]:
            rows = tuple(range(dz.ndim - 1))
            grads[3] = dz.to(pol.acc_dtype).sum(rows).to(ctx.dtypes[3])
        if need[4]:
            grads[4] = dout.to(ctx.dtypes[4])
        return (*grads, None)


def _mma_gemm(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor | None = None,
              *, kind: Ger = Ger.BF16GER2,
             block: tuple[int, int, int] | None = None,
             neg_product: bool = False, neg_acc: bool = False,
             alpha: float = 1.0, beta: float = 1.0,
             ep: _epilogue.Epilogue | None = None,
             bias: torch.Tensor | None = None,
             residual: torch.Tensor | None = None,
             out_dtype: torch.dtype | None = None,
             x_layout: packing.GemmLayout | None = None,
             y_layout: packing.GemmLayout | None = None,
             masks: tuple | None = None, checksum: bool = False,
             tuned: tuple | None = None):
    """The dispatch of one product: the plain version on a CPU tensor, a
    kernel on a CUDA tensor; with ``checksum`` also the sidecar."""
    pol = precision.policy(kind)
    if kind == Ger.F32GER_3XBF16:
        raise ValueError(
            "F32GER_3XBF16 is a registered expansion hook — lower it "
            "through facility.contract (core/lowering.py), which chains "
            "three BF16GER2 kernel passes over one accumulator")
    packed = x_layout is not None or y_layout is not None
    if packed:
        if pol.packed_int4:
            raise ValueError("prepacked layouts are byte-addressable tiles; "
                             "packed-int4 kinds keep their nibble packing")
        b, m, n, k = _packed_shapes(x, y, x_layout, y_layout)
    else:
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
    masks = _check_masks(masks, pol, m, n, k, x.device)
    forms = dict(neg_product=neg_product, neg_acc=neg_acc, alpha=alpha,
                 beta=beta, ep=ep, bias=bias, residual=residual,
                 out_dtype=out_dtype)
    # the one path choice: the natural operands', which a packed call
    # follows (its result is then the natural one bit for bit); a winner
    # the call cannot take gives way to the heuristic, counted
    path, cfg = tiling.choose_gemm_path(
        m, n, k, kind, b or 1, natural_aligned(x, y, x_layout, y_layout),
        block, masks is not None, tuned if block is None else None)
    if tuned is not None and block is None and (path, cfg) != tuned:
        mma_gemm.tuned_fallbacks += 1
    if checksum and path not in SIDECAR_PATHS:
        raise NotImplementedError(
            f"the {path} kernel takes no checksum sidecar: ABFT does not "
            f"verify integer accumulators ({kind.value})")
    if packed:
        _panels(path, x, x_layout, "x")
        _panels(path, y, y_layout, "y")
    if masks is not None:
        forms["masks"] = masks
    if x.device.type == "cpu":
        # the plain versions read the panels as the kernel-facing matrix
        if x_layout is not None:
            x = packing.gemm_panels_matrix(x, x_layout)
        if y_layout is not None:
            y = packing.gemm_panels_matrix(y, y_layout)
        plain = _plain_of(path, cfg, k)
        if not checksum:
            return plain(x, y, c, kind=kind, **forms)
        # the finished accumulator-dtype result, then its cast: the same
        # operations, so ``out`` is the checksum=False output bit for bit
        fin = plain(x, y, c, kind=kind, **{**forms,
                                           "out_dtype": pol.acc_dtype})
        return (fin.to(out_dtype),
                *checksum_tiles(fin, *sidecar_tile(path, cfg, m)))
    if x.device.type != "cuda":
        raise ValueError(f"mma_gemm runs on cuda (or its plain version on "
                         f"cpu), not {x.device}")
    if (b or 1) > 65535:
        raise ValueError(f"grid too large for one launch: b={b}")
    for t in (y, c, bias, residual):
        if t is not None and t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
    ck = None
    if checksum:
        bm, bn = sidecar_tile(path, cfg, m)
        lead = () if b is None else (b,)
        # every tile writes its own sums: no fill needed
        ck = (torch.empty(lead + (-(-m // bm), n), dtype=pol.acc_dtype,
                          device=x.device),
              torch.empty(lead + (m, -(-n // bn)), dtype=pol.acc_dtype,
                          device=x.device))
    if (b or 1) * m * n == 0:       # an empty grid is not a launch
        out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
        return (out, *ck) if checksum else out
    panels = ((1 if x_layout is not None else 0)
              | (2 if y_layout is not None else 0))
    x = x if x_layout is not None else x.contiguous()
    y = y if y_layout is not None else y.contiguous()
    # each operand's batch stride in elements: 0 where it is shared (a
    # packed operand without the batch axis of a batched call)
    strides = tuple(
        t[0].numel() if b is not None and t.ndim == rank else 0
        for t, rank in ((x, 3 if x_layout is None else 5),
                        (y, 3 if y_layout is None else 5)))
    mptrs = (None, None, None) if masks is None else tuple(
        _ptr(t) for t in masks)
    forms.pop("masks", None)
    ck_ptrs = (None, None) if ck is None else (ck[0].data_ptr(),
                                               ck[1].data_ptr())
    launched = dict(panels=panels, strides=strides, masks=mptrs, ck=ck_ptrs,
                    **forms)
    if path in ("imma", "dmma"):
        out = _launch_imma_dmma(path, cfg, x, y, c, pol, b, m, n, k,
                                **launched)
    else:
        out = _launch_16bit_f32(path, cfg, x, y, c, b, m, n, k, **launched)
    mma_gemm.launches += 1
    mma_gemm.launches_by_path[path] += 1
    if panels:
        mma_gemm.packed_launches_by_path[path] += 1
    if masks is not None:
        mma_gemm.masked_launches_by_path[path] += 1
    if checksum:
        mma_gemm.checksum_launches_by_path[path] += 1
    if mma_gemm.trace is not None:
        mma_gemm.trace.append((b or 1, m, k, n, x.dtype, out_dtype, path))
    return (out, *ck) if checksum else out


def _check_masks(masks, pol, m, n, k, device):
    """The pm* predicates as the kernels take them: None where no entry is
    set, else a 3-tuple of None or contiguous uint8 tensors, each shape
    checked (pmask over logical K)."""
    if masks is None or all(t is None for t in masks):
        return None
    if len(masks) != 3:
        raise ValueError(f"masks wants the 3-tuple (xmask, ymask, pmask), "
                         f"got {len(masks)} entries")
    xm, _, pm = masks
    if (xm is not None or pm is not None) and pol.packed_int4:
        raise ValueError(
            "packed-int4 masked forms lower through the ref.pm_ger oracle "
            "(nibble unpacking and rank predicates do not compose in the "
            "streamed kernel)")
    logical_k = 2 * k if pol.packed_int4 else k
    out = []
    for i, (t, want) in enumerate(zip(masks, (m, n, logical_k))):
        if t is not None:
            if tuple(t.shape) != (want,):
                raise ValueError(f"mask {i} has shape {tuple(t.shape)}; "
                                 f"want ({want},)")
            if t.device != device:
                raise ValueError(f"mask {i} on {t.device}, operands on "
                                 f"{device}")
            t = t.to(torch.bool).to(torch.uint8).contiguous()
        out.append(t)
    return tuple(out)


def _panels(path, t, lay, side):
    """Check ``side``'s packed panels before ``path`` reads them: they must
    be the panel size every path reads, contiguous and 16-byte aligned
    (their pointer goes to the kernel untouched)."""
    if lay is None:
        return
    if lay.panel_blocks != packing.PANELS[side]:
        raise ValueError(f"stale packed layout: panels {lay.panel_blocks} "
                         f"but the {path} path reads "
                         f"{packing.PANELS[side]} — repack "
                         f"(packing.refresh_gemm); never read stale panels")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("packed panels must be contiguous and 16-byte "
                         "aligned")


def _launch_imma_dmma(path, cfg, x, y, c, pol, b, m, n, k, *, neg_product,
                      neg_acc, alpha, beta, ep, bias, residual, out_dtype,
                      masks, ck, panels, strides):
    """One launch of csrc/gemm_imma.cu (the integer families) or
    csrc/gemm_dmma.cu (F64GER); ``masks`` the three predicate pointers
    (None: no predicate), ``ck`` the DMMA sidecar's two (None: none),
    ``panels`` which operands are packed panels (bit 0 x, bit 1 y; 0: natural
    rows), ``strides`` x's and y's batch strides.  The seed,
    bias and residual go to the accumulator dtype first, as the reference
    casts them."""
    if out_dtype not in STORE_CODES:
        raise NotImplementedError(f"the {path} kernel stores int32/f64/f32/"
                                  f"bf16/f16, not {out_dtype}")
    if -(-m // cfg.bm) > 65535:
        raise ValueError(f"grid too large for one launch: m={m}")
    acc = pol.acc_dtype
    c, bias, residual = (t.to(acc).contiguous() if t is not None else None
                         for t in (c, bias, residual))
    out = torch.empty((m, n) if b is None else (b, m, n), dtype=out_dtype,
                      device=x.device)
    strides = (*strides, m * n, m * n, m * n)
    ptrs = (x.data_ptr(), y.data_ptr(), *masks, _ptr(c), _ptr(bias),
            _ptr(residual), out.data_ptr())
    act = ep.activation if ep is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if path == "imma":
        lib, fn = _lib("gemm_imma", "gemm_imma_launch", _IMMA_ARGTYPES)
        logical_k = 2 * k if pol.packed_int4 else k
        rc = fn(*ptrs, tiling.IMMA_GERS.index(pol.ger),
                STORE_CODES[out_dtype], b or 1, m, n, logical_k, *strides,
                acc_scalar(alpha, pol), acc_scalar(beta, pol),
                int(neg_product), int(neg_acc), int(act == "relu"), stream,
                panels)
    else:
        lib, fn = _lib("gemm_dmma", "gemm_dmma_launch", _DMMA_ARGTYPES)
        rc = fn(*ptrs, STORE_CODES[out_dtype], b or 1, m, n, k, *strides,
                float(alpha), float(beta), int(neg_product), int(neg_acc),
                _epilogue.ACT_CODES[act], cfg.bm, cfg.bn, cfg.bk, *ck,
                stream, panels)
    _build.check(lib, rc, f"mma_gemm ({path})")
    return out


def _launch_16bit_f32(path, cfg, x, y, c, b, m, n, k, *, neg_product,
                      neg_acc, alpha, beta, ep, bias, residual, out_dtype,
                      masks, ck, panels, strides):
    """One launch of the weight stream, the wgmma tile or the WMMA tiles
    (the bf16/f16/f32 families); ``panels``: which operands are packed
    panels (bit 0 x, bit 1 y; 0: natural rows), ``strides`` x's and
    y's batch strides; ``masks`` the three predicate pointers, which
    only the WMMA tiles take; ``ck`` the sidecar's (ck_col, ck_row)
    pointers (None, None: no sidecar)."""
    if out_dtype not in DTYPE_CODES:
        raise NotImplementedError(f"the GEMM kernel stores f32/bf16/f16, "
                                  f"not {out_dtype}")
    c = c.contiguous() if c is not None else None
    bias = bias.contiguous() if bias is not None else None
    residual = residual.contiguous() if residual is not None else None
    out = torch.empty((m, n) if b is None else (b, m, n), dtype=out_dtype,
                      device=x.device)
    batched = b is not None
    common = (_ptr(c), _ptr(bias), _ptr(residual), out.data_ptr())
    codes = (_code(c), _code(bias), _code(residual), DTYPE_CODES[out_dtype])
    forms = (float(alpha), float(beta), int(neg_product), int(neg_acc),
             _epilogue.ACT_CODES[ep.activation if ep is not None else None])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if path == "stream":
        # the (B, split, M, N) fp32 partials, from the stream-ordered
        # caching allocator, where the kernel writes them (split K on the
        # cp.async kernels, slices spanning units on the TMA one), and the
        # stream's zeroed tickets, one a (batch, N tile)
        run = cfg.run(n, b or 1)
        tma = x.dtype != torch.float32 and stream_tma_reads(
            x, y, k, n, panels, strides)
        parts = tickets = None
        if (run < cfg.split) if tma else cfg.split > 1:
            parts = torch.empty((b or 1) * cfg.split * m * n,
                                dtype=torch.float32, device=x.device)
        if cfg.split > 1:
            tickets = _stream_tickets(x.device, (b or 1) * cfg.grid(n)[0])
        lib, fn = _lib("gemm_stream", "gemm_stream_launch", _STREAM_ARGTYPES)
        rc = fn(x.data_ptr(), y.data_ptr(), *common, _ptr(parts),
                _ptr(tickets),
                DTYPE_CODES[x.dtype], *codes, b or 1, m, n, k, *forms,
                cfg.bn, cfg.split, run, *ck, stream, panels, *strides)
    elif path == "wgmma":
        lib, fn = _lib("gemm_wgmma", "gemm_wgmma_launch", _WGMMA_ARGTYPES)
        rc = fn(x.data_ptr(), y.data_ptr(), *common, DTYPE_CODES[x.dtype],
                *codes, b or 1, int(batched), m, n, k, *forms, cfg.bn,
                *ck, stream, panels, *strides)
    else:
        if -(-m // cfg.bm) > 65535:
            raise ValueError(f"grid too large for one launch: m={m}")
        lib, fn = _lib("mma_gemm", "mma_gemm_launch", _ARGTYPES)
        rc = fn(x.data_ptr(), y.data_ptr(), *masks, *common,
                DTYPE_CODES[x.dtype], *codes, b or 1, m, n, k, *strides,
                m * n, m * n, m * n, *forms, cfg.bm, cfg.bn, cfg.bk, *ck,
                stream, panels)
    _build.check(lib, rc, f"mma_gemm ({path})")
    return out


def stream_tma_reads(x, y, k: int, n: int, panels: int, strides) -> bool:
    """Whether csrc/gemm_stream.cu's TMA kernel reads a 16-bit product's
    operands (as its launcher decides): each as packed panels, or as
    natural rows with a 16-byte base and pitch (X's K, the weight's N)
    and batch stride; else the cp.async kernel runs."""
    x_ok = bool(panels & 1) or (k % 8 == 0 and x.data_ptr() % 16 == 0
                                and strides[0] % 8 == 0)
    y_ok = bool(panels & 2) or (n % 8 == 0 and y.data_ptr() % 16 == 0
                                and strides[1] % 8 == 0)
    return x_ok and y_ok


# The weight stream's tickets, one zeroed int32 buffer a (device, CUDA
# stream): the block that finishes a tile sets its ticket back to 0, so a
# buffer stays zeroed between the launches on its stream, which the
# stream orders, and no launch needs a memset first.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _stream_tickets(device, count: int) -> torch.Tensor:
    """The current stream's ticket buffer, at least ``count`` long (grown
    as a fresh zeroed buffer: the old one goes back to the stream's own
    pool, after the launches before it)."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < count:
        buf = _TICKETS[key] = torch.zeros(max(count, 4096),
                                          dtype=torch.int32, device=device)
    return buf


mma_gemm.launches = 0
mma_gemm.launches_by_path = dict.fromkeys(PATHS, 0)
# The launches on packed panels (also in launches_by_path), by path.
mma_gemm.packed_launches_by_path = dict.fromkeys(PACKED_PATHS, 0)
# The launches with pm* predicates (also in launches_by_path), by path.
mma_gemm.masked_launches_by_path = dict.fromkeys(MASKED_PATHS, 0)
# The launches with the checksum sidecar (also in launches_by_path).
mma_gemm.checksum_launches_by_path = dict.fromkeys(SIDECAR_PATHS, 0)
# A list to record (batch, M, K, N, dtype, out dtype, path) of each launch
# into, or None: chip_smoke.py times the shapes a run gave the kernels.
mma_gemm.trace = None
# The calls whose tuned winner the call could not take, so that the
# heuristic ran (not launches: counted on the CPU too).
mma_gemm.tuned_fallbacks = 0
