"""The lowering registry beneath ``facility.contract`` (port of
``repro.core.lowering``: the gemm, gemm.saturating, complex, conv, attn and
einsum parts, and the quant path's :class:`Dequant`).

``facility.contract(spec, x, y, plan=...)`` parses an einsum-like
contraction spec, resolves a :class:`Plan` against the ambient
``FacilityConfig``, and dispatches to a registered lowering.

Registry
--------
Lowerings register per ``(backend, op_class, ger, fused)`` key:

  * ``backend``: ``"kernel"`` (the hand-written Hopper kernels; on a CPU
    tensor each kernel wrapper runs its plain version), ``"torch"`` (eager
    torch ops, in place of the reference's ``xla``), ``"ref"`` (the eager
    architected oracles — ground truth).
  * ``op_class``: ``"gemm"`` (any spec that normalizes to a — possibly
    batched — 2-D GEMM; batch rides the kernel's ``blockIdx.z``),
    ``"gemm.masked"`` (the pm* prefixed forms: a natural-layout gemm with
    the ``(xmask, ymask, pmask)`` row/column/rank predicates, which the
    kernels apply while staging their panels and the torch/ref lowerings
    fold into the operands as selects),
    ``"conv"`` (the canonical NHWC conv specs, stride and valid/same/causal
    padding in the Plan), ``"attn"`` (the canonical three-operand ATTN
    spec), ``"einsum"`` (general contraction fallback, eager on every
    backend, as the reference's einsum fell to xla), ``"gemm.saturating"``
    (the xvi16ger2s / xvi8ger4spp forms: each rank-r update clamped to
    int32; ``torch`` and ``ref`` lowerings only, so the kernel backend
    routes it to ``torch`` by its op-class, statically, as the reference
    routes pallas to xla: a fixed route, not a fallback after a failure)
    and ``"complex"`` (complex operands: four real accumulate-form gers
    through whichever backend's gemm lowering the op resolves to, the
    kernel's included).
  * ``ger``/``fused``: optional specializations; lookup falls back from the
    most specific key to ``(backend, op_class, None, None)``.

Autotuned dispatch
------------------
Every kernel-backend GEMM, dense conv and attention dispatch consults the
autotune cache (``core/autotune.py``) for its shape, in the reference's
order: an explicit ``Plan.block`` wins, then a cached winner
(:func:`resolve_block`; attention: ``autotune.lookup_attn``), else the
kernel wrapper's heuristic.  A winner names a kernel path and config; a
call that cannot take it runs the heuristic, and the wrapper counts it.
The conv consults the GEMM cache at (OW, F, KW*C), as the reference does,
and applies only the winner's filter tile where K3 has it.

Guarded dispatch
----------------
With ``FacilityConfig(guards=True)`` each contract output passes a NaN/Inf
detector and lowering failures demote down the ladder kernel -> torch ->
ref, quarantined per (op-class, ger, spec, shapes) (:func:`_guarded_dispatch`;
with ``abft=True`` also checksum verification, ``core/abft.py``).  A kernel
that fails to build or launch raises ``RuntimeError`` (``_build.check``),
which is not one of :data:`LOWERING_ERRORS`: it raises under guards too and
never demotes silently to another backend.  With guards off the dispatch is
one contextvar read away from ``fn(op)``.

Packed operands
---------------
A ``core.packing.PackedOperand`` may stand in for a weight.
``_admit_packed`` keeps it packed for the single-pass kernel gemm and
dense conv lowerings, whose dispatch takes the path its natural operands
would and streams its panels (every path reads them, both operands' at
once), and for the torch/ref gemm and conv lowerings, which demote it;
every other case demotes at admission.  Each demote is counted
(``packing.COUNTERS``), so a packed result is the natural one bit for bit.

Gradients
---------
Every lowering is differentiable.  The ``torch`` and ``ref`` lowerings are
eager torch ops under plain autograd.  The ``kernel`` routes reach the
kernel wrappers, each a ``torch.autograd.Function`` where an operand
requires a gradient: the GEMM's backward is more GEMM products on its
kernels; the backward of attention and of both convolutions is, statically,
this module's torch lowering (``torch_attention``, ``torch_conv``)
differentiated on a recomputation, because no TPU backward kernel exists
to port (the reference's Pallas kernels have no gradient).  That is a
static route like the einsum one, not a failure fallback.

ACC lifecycle
-------------
Every gemm-class lowering implements the same three-phase accumulator
lifecycle (paper fig. 4 — prime, rank-k updates, deprime):

    prime    acc <- 0 | [-] beta * C
    update   acc <- acc [-] X_i @ Y_i         (one per rank-k pass)
    deprime  out <- cast(epilogue(alpha * acc))

An integer accumulator is int32 and wraps modulo 2**32, with alpha and
beta truncated to integers, as in the reference.  ``execute`` applies a
:class:`Dequant` (the quant path's rescale) after the lowering, on the
accumulator-dtype matrix in output orientation.

The CUDA kernel realizes it in registers and shared memory
(csrc/mma_gemm.cu); the torch and ref lowerings with the explicit
:class:`Accumulator`.  The ``F32GER_3XBF16`` expansion hook rewrites one
fp32 pass into three chained bf16 passes over one accumulator.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import logging
import warnings

import torch

from repro_torch.core import abft as _abft
from repro_torch.core import autotune as _autotune
from repro_torch.core import packing, precision, tiling
from repro_torch.kernels import epilogue as _epilogue_mod
from repro_torch.kernels import mma_attention as _attn
from repro_torch.kernels import mma_conv as _conv
from repro_torch.kernels import mma_gemm as _gemm
from repro_torch.kernels import ref as _ref
from repro_torch.parallel import api as _par
from repro_torch.runtime import faults as _faults

Ger = precision.Ger
_acc_scalar = _gemm.acc_scalar

Epilogue = _epilogue_mod.Epilogue
make_epilogue = _epilogue_mod.make
repeat_kv = _attn.repeat_kv

# Sentinel for Plan.out_dtype: keep the accumulator dtype.
ACC = "acc"


# ----------------------------------------------------------------------
# Plan: the architected call signature of the builtin
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """Static description of one ``contract`` call.  ``None`` fields
    resolve against the ambient FacilityConfig at dispatch."""

    ger: Ger | None = None            # rank-k family; None -> config
    out_dtype: object = None          # None -> config; ACC -> acc dtype
    backend: str | None = None        # None -> config ("kernel")
    epilogue: object = None           # kernels.epilogue.Epilogue | None
    block: tuple | None = None        # kernel tile override
    # Accumulate forms (paper eq. 2): out = alpha * [-](X@Y) + beta * [-]C
    neg_product: bool = False
    neg_acc: bool = False
    alpha: float = 1.0
    beta: float = 1.0
    saturating: bool = False          # xvi16ger2s-style clamped updates
    # Conv op-class only (spec is one of the canonical conv specs below):
    stride: object = 1                # int, or one value per spatial dim
    padding: str = "valid"            # valid | same | causal
    # Attn op-class only (spec is the canonical ATTN spec below):
    causal: bool = False              # q attends k with k_pos <= q_pos
    window: int | None = None         # sliding window: q_pos - k_pos < window
    q_offset: int = 0                 # absolute position of q[0]
    q_chunk: int = 0                  # torch lowering's q-chunk (0 = default)
    # Mesh binding for the shard-aware dispatch: None -> the ambient
    # parallel.api rules (model code stays annotation-only); False ->
    # single-device lowering even under an active mesh; a DeviceMesh or
    # parallel.api.ShardingRules binds explicitly; a parallel.api.BankShard
    # runs single-device on the plan of a batch BankShard.factor times
    # larger (contracts issued inside an expert exchange's per-shard body).
    mesh: object = None


# Conv specs: convolutions are not two-operand einsums (the sliding window
# reuses input elements), so the facility names them with canonical specs
# (NHWC / HWIO layouts) and ``execute`` routes them to the conv op-class.
CONV2D = "nhwc,hwio->nhwo"            # dense 2-D conv
CONV1D = "nlc,lio->nlo"               # dense 1-D conv over the L axis
CONV1D_DEPTHWISE = "nlc,lc->nlc"      # per-channel taps (groups == C)

# spec -> (spatial ndim, depthwise)
_CONV_SPECS = {CONV2D: (2, False), CONV1D: (1, False),
               CONV1D_DEPTHWISE: (1, True)}

# Fused scaled-dot-product attention: q (B, Sq, H, D); k, v (B, Sk, KVH, D)
# with H % KVH == 0 (GQA head groups).
ATTN = "bqhd,bkhd->bqhd"

# The torch attn lowering's default query-chunk length: at most
# (B, H, chunk, Sk) scores are live at once.
ATTN_Q_CHUNK = 1024

# Families the attention lowerings accept: float operands, f32 accumulator.
_ATTN_GERS = (Ger.F32GER, Ger.BF16GER2, Ger.F16GER2)

# ----------------------------------------------------------------------
# Spec parsing: einsum-like contraction specs -> GEMM structure
# ----------------------------------------------------------------------

_ELL_LABELS = "ZYXWVU"   # reserved labels for '...' expansion


@dataclasses.dataclass(frozen=True)
class ParsedSpec:
    """Static contraction structure for one (spec, x.ndim, y.ndim)."""

    x_labels: tuple[str, ...]
    y_labels: tuple[str, ...]
    out_labels: tuple[str, ...]
    batch: tuple[str, ...]       # in both inputs and the output
    contract: tuple[str, ...]    # in both inputs, not the output
    x_free: tuple[str, ...]      # "M" labels
    y_free: tuple[str, ...]      # "N" labels

    @property
    def natural_out(self) -> tuple[str, ...]:
        """The normalized output order: batch, then M, then N labels."""
        return self.batch + self.x_free + self.y_free

    @property
    def out_perm(self) -> tuple[int, ...] | None:
        """Transpose taking natural_out to the spec's output order."""
        nat = self.natural_out
        if nat == self.out_labels:
            return None
        return tuple(nat.index(d) for d in self.out_labels)

    @property
    def is_natural_gemm(self) -> bool:
        """True when operands and output are already in the normalized
        (batch..., M, K) x (batch..., K, N) -> (batch..., M, N) layout
        with single M/N/K labels -- the layout the masked op-class
        requires so its (M,), (N,), (K,) predicates name unique axes."""
        return (len(self.x_free) == 1 and len(self.y_free) == 1
                and len(self.contract) == 1
                and self.x_labels == self.batch + self.x_free + self.contract
                and self.y_labels == self.batch + self.contract + self.y_free
                and self.out_perm is None)


def _expand_ellipsis(labels: str, ndim: int, spec: str) -> tuple[str, ...]:
    if "..." not in labels:
        out = tuple(labels)
        if len(out) != ndim:
            raise ValueError(
                f"spec {spec!r}: operand term {labels!r} has "
                f"{len(out)} labels for a {ndim}-d operand")
        return out
    head, _, tail = labels.partition("...")
    n_ell = ndim - len(head) - len(tail)
    if n_ell < 0:
        raise ValueError(f"spec {spec!r}: {labels!r} over-labels "
                         f"a {ndim}-d operand")
    if n_ell > len(_ELL_LABELS):
        raise ValueError(f"spec {spec!r}: '...' spans {n_ell} dims "
                         f"(max {len(_ELL_LABELS)})")
    # Labels come off the END of the pool so that, einsum-style, the
    # ellipses of two operands with different ranks align on their LAST
    # dims.
    return (tuple(head) + tuple(_ELL_LABELS[len(_ELL_LABELS) - n_ell:])
            + tuple(tail))


@functools.lru_cache(maxsize=None)
def parse_spec(spec: str, x_ndim: int, y_ndim: int) -> ParsedSpec | None:
    """Parse a two-operand contraction spec; None when it is not a
    (batched) GEMM the gemm lowerings can take — the caller then falls
    back to the general einsum lowering."""
    s = spec.replace(" ", "")
    try:
        lhs, out_s = s.split("->")
        xs_s, ys_s = lhs.split(",")
    except ValueError:
        raise ValueError(f"bad contraction spec {spec!r}; want 'ab,bc->ac'")
    for term in (xs_s, ys_s):
        if any(c in _ELL_LABELS for c in term.replace(".", "")):
            return None   # user labels collide with the ellipsis pool
    xs = _expand_ellipsis(xs_s, x_ndim, spec)
    ys = _expand_ellipsis(ys_s, y_ndim, spec)
    if "..." in out_s:
        n_ell = max(len(xs) - len(xs_s.replace("...", "")),
                    len(ys) - len(ys_s.replace("...", "")))
        head, _, tail = out_s.partition("...")
        outs = (tuple(head) + tuple(_ELL_LABELS[len(_ELL_LABELS) - n_ell:])
                + tuple(tail))
    else:
        outs = tuple(out_s)
    xset, yset, oset = set(xs), set(ys), set(outs)
    if (len(xset) != len(xs) or len(yset) != len(ys)
            or len(oset) != len(outs)):
        return None   # repeated label within a term (diagonal): not a GEMM
    if not oset <= (xset | yset):
        raise ValueError(f"spec {spec!r}: output labels {oset - xset - yset}"
                         f" appear in no input")
    # Labels in exactly one input must survive to the output, otherwise the
    # spec asks for a plain sum-reduction — not GEMM-shaped.
    if (xset - yset) - oset or (yset - xset) - oset:
        return None
    batch = tuple(d for d in xs if d in yset and d in oset)
    contract = tuple(d for d in xs if d in yset and d not in oset)
    x_free = tuple(d for d in xs if d not in yset)
    y_free = tuple(d for d in ys if d not in xset)
    return ParsedSpec(xs, ys, outs, batch, contract, x_free, y_free)


def _ellipsis_broadcasts(parsed: ParsedSpec, x, y) -> bool:
    """True when an ellipsis-derived label has size 1 on one operand and
    >1 on the other — einsum broadcasting the GEMM normalizer cannot
    express, so the caller routes to the general einsum lowering."""
    sizes: dict[str, int] = {}
    for labels, shape in ((parsed.x_labels, x.shape),
                          (parsed.y_labels, y.shape)):
        for d, n in zip(labels, shape):
            prev = sizes.setdefault(d, n)
            if prev != n and d in _ELL_LABELS and 1 in (prev, n):
                return True
    return False


def _sizes(parsed: ParsedSpec, x, y) -> dict[str, int]:
    sizes: dict[str, int] = {}
    for labels, arr in ((parsed.x_labels, x), (parsed.y_labels, y)):
        for d, n in zip(labels, arr.shape):
            if sizes.setdefault(d, n) != n:
                raise ValueError(
                    f"size mismatch for label {d!r}: {sizes[d]} vs {n} "
                    f"({tuple(x.shape)} x {tuple(y.shape)})")
    return sizes


def _prod(ns) -> int:
    out = 1
    for n in ns:
        out *= n
    return out


# ----------------------------------------------------------------------
# The explicit ACC lifecycle (torch / ref lowerings)
# ----------------------------------------------------------------------

class Accumulator:
    """prime -> rank-k updates -> deprime, at matrix granularity."""

    def __init__(self, pol: precision.GerPolicy):
        self.pol = pol
        self.value = None

    def prime(self, c=None, *, beta: float = 1.0, neg_acc: bool = False):
        if c is None:
            self.value = None       # lazy zeros: first update sets it
            return self
        v = c.to(self.pol.acc_dtype)
        if beta != 1.0:
            v = v * _acc_scalar(beta, self.pol)
        self.value = -v if neg_acc else v
        return self

    def update(self, x, y, *, neg_product: bool = False):
        """acc <- acc [-] X @ Y, accumulating in the family's acc dtype
        (``ref.product``: int4 unpacked, integer products wrapped)."""
        prod = _ref.product(x, y, self.pol)
        if neg_product:
            prod = -prod
        self.value = prod if self.value is None else prod + self.value
        return self

    def deprime(self, *, alpha: float = 1.0, epilogue=None, bias=None,
                residual=None, out_dtype=None):
        out = self.value
        if alpha != 1.0:
            out = out * _acc_scalar(alpha, self.pol)
        out = _epilogue_mod.apply(out, epilogue, bias=bias,
                                  residual=residual)
        return out.to(out_dtype) if out_dtype is not None else out


@dataclasses.dataclass
class Dequant:
    """Deprime-stage rescale turning an int32 ``I8GER4`` accumulator into
    floating point -- the W8A8 zero-point form of ``quant.qdot``:

        out = row_scale * (acc - row_zp * col_sum) * col_scale

    Applied by ``execute`` on the accumulator-dtype matrix in output
    orientation, the same on every backend, so the backends of the quant
    path agree as far as the int32 ger itself does (bit for bit).
    """

    row_scale: torch.Tensor   # (M, 1) activation scales
    row_zp: torch.Tensor      # (M, 1) activation zero points
    col_sum: torch.Tensor     # (N,)  weight column sums (int32 -> fp32)
    col_scale: torch.Tensor   # (1, N) or (N,) weight scales

    def apply(self, acc):
        out = acc.to(torch.float32)
        out = self.row_scale * out \
            - (self.row_scale * self.row_zp) * self.col_sum[None, :]
        return out * self.col_scale


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------

_REGISTRY: dict[tuple, object] = {}
_EXPANSIONS: dict[Ger, tuple[Ger, object]] = {}

BACKENDS = ("kernel", "torch", "ref")

# Contract dispatches by (backend that ran, op-class, ger value): under
# guards the rung that returned the output.  Reset with
# ``DISPATCH_COUNTS.clear()``.
DISPATCH_COUNTS: collections.Counter = collections.Counter()


def register(backend: str, op_class: str, *, ger: Ger | None = None,
             fused: bool | None = None):
    """Decorator: register a lowering for ``(backend, op_class[, ger,
    fused])``.  ``None`` wildcards match any family / fusion state."""

    def deco(fn):
        _REGISTRY[(backend, op_class, ger, fused)] = fn
        return fn
    return deco


def lookup(backend: str, op_class: str, ger: Ger, fused: bool):
    """Most-specific-first lookup with wildcard fallbacks."""
    for key in ((backend, op_class, ger, fused),
                (backend, op_class, ger, None),
                (backend, op_class, None, fused),
                (backend, op_class, None, None)):
        fn = _REGISTRY.get(key)
        if fn is not None:
            return fn
    return None


def backends_for(op_class: str, ger: Ger, fused: bool = False) -> list[str]:
    """Which backends can lower this key (cross-backend test surface)."""
    return [b for b in BACKENDS if lookup(b, op_class, ger, fused)]


def register_expansion(ger: Ger, rep: Ger):
    """Register a pre-processing hook rewriting one ``ger`` pass into a
    chain of passes over the same accumulator, run as family ``rep``."""

    def deco(fn):
        _EXPANSIONS[ger] = (rep, fn)
        return fn
    return deco


@register_expansion(Ger.F32GER_3XBF16, Ger.BF16GER2)
def _expand_f32_3xbf16(x, y):
    """fp32 operands emulated on the bf16 tensor cores: split hi/lo bf16
    and chain hi*hi + hi*lo + lo*hi rank-k passes."""

    def split(v):
        v = v.to(torch.float32)
        hi = v.to(torch.bfloat16)
        lo = (v - hi.to(torch.float32)).to(torch.bfloat16)
        return hi, lo

    xh, xl = split(x)
    yh, yl = split(y)
    return [(xh, yh, Ger.BF16GER2), (xh, yl, Ger.BF16GER2),
            (xl, yh, Ger.BF16GER2)]


def _passes(ger: Ger, x, y):
    hook = _EXPANSIONS.get(ger)
    if hook is None:
        return [(x, y, ger)]
    return hook[1](x, y)


def rep_kind(ger: Ger) -> Ger:
    """The family whose policy governs tiles after expansion."""
    hook = _EXPANSIONS.get(ger)
    return ger if hook is None else hook[0]


def resolve_block(kind: Ger, m: int, n: int, k: int,
                  block: tuple[int, int, int] | None,
                  epilogue_key: str = "none", b: int = 1,
                  device: str = "cuda"):
    """Dispatch-time autotune-cache consult: ``(block, tuned)`` for the
    GEMM wrapper.  An explicit ``block`` wins (``tuned`` None); then a
    cached winner for ``device``'s backend, a (path, config) pair (batched
    contractions consult their own (b, m, n, k) key); else (None, None):
    the wrapper's heuristic."""
    if block is not None:
        return tuple(block), None
    return None, _autotune.lookup(rep_kind(kind), m, n, k, epilogue_key,
                                  backend=device, b=b)


# ----------------------------------------------------------------------
# Resolved op: everything a lowering needs
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Op:
    """One fully-resolved contract invocation handed to a lowering."""

    x: torch.Tensor
    y: torch.Tensor
    acc: torch.Tensor | None
    bias: torch.Tensor | None
    residual: torch.Tensor | None
    parsed: ParsedSpec | None
    spec: str
    ger: Ger
    pol: precision.GerPolicy
    out_dtype: torch.dtype        # final dtype for THIS lowering call
    epilogue: Epilogue            # never None; identity allowed
    block: tuple | None
    neg_product: bool
    neg_acc: bool
    alpha: float
    beta: float
    # attn op-class: the value operand, the (B, Sk) valid-slot predicate,
    # and the static attention vocabulary resolved from the Plan.
    z: torch.Tensor | None = None
    valid: torch.Tensor | None = None
    causal: bool = False
    window: int | None = None
    q_offset: int = 0
    q_chunk: int = 0
    # conv op-class: per-spatial-dim stride and the padding mode.
    stride: tuple = ()
    padding: str = "valid"
    # the resolved backend (the complex lowering runs its gemm lowering)
    backend: str = "kernel"
    # gemm.masked: the pm* (xmask (M,), ymask (N,), pmask (K,)) predicates,
    # each None or a bool tensor
    masks: tuple | None = None
    # the kernel plan a mesh dispatch resolved at the global shape and
    # pins for every shard: gemm {pass family: (path, config)}, attn
    # (bq, n_split), dense conv (path, config)
    pinned: object = None

    @property
    def fused(self) -> bool:
        return not self.epilogue.is_identity

    @property
    def has_forms(self) -> bool:
        return (self.neg_product or self.neg_acc
                or self.alpha != 1.0 or self.beta != 1.0)

    def to_batched_2d(self):
        """Normalize operands to ``(B, M, K) x (B, K, N)`` (B omitted when
        there are no batch labels).  Returns (x2, y2, (b, m, n, k),
        assemble) where ``assemble`` maps the (B?, M, N) result back to
        the spec's output shape/order."""
        p = self.parsed
        sizes = _sizes(p, self.x, self.y)
        bshape = tuple(sizes[d] for d in p.batch)
        mshape = tuple(sizes[d] for d in p.x_free)
        nshape = tuple(sizes[d] for d in p.y_free)
        kshape = tuple(sizes[d] for d in p.contract)
        b, m, n, k = (_prod(bshape), _prod(mshape), _prod(nshape),
                      _prod(kshape))
        batched = bool(p.batch)

        def norm(arr, labels, order, shape):
            if packing.is_packed(arr):
                # a prepacked operand is already in its kernel-native
                # layout (orientation checked at admission): the
                # normalization is exactly the relayout its pack paid once
                return arr
            perm = tuple(labels.index(d) for d in order)
            if perm != tuple(range(len(perm))):
                arr = arr.permute(perm)
            return arr.reshape(shape)

        x2 = norm(self.x, p.x_labels, p.batch + p.x_free + p.contract,
                  (b, m, k) if batched else (m, k))
        y2 = norm(self.y, p.y_labels, p.batch + p.contract + p.y_free,
                  (b, k, n) if batched else (k, n))

        def assemble(out):
            out = out.reshape(bshape + mshape + nshape)
            if p.out_perm is not None:
                axis_of = {d: i for i, d in enumerate(p.natural_out)}
                out = out.permute(tuple(axis_of[d] for d in p.out_labels))
            return out

        return x2, y2, (b if batched else None, m, n, k), assemble


def _combine_expanded(op: Op, prod, acc_seed, residual):
    """Shared tail of a multi-pass expansion chain: apply the accumulate
    forms to the chained product, then deprime once."""
    acc = Accumulator(op.pol)
    acc.value = -prod if op.neg_product else prod
    if acc_seed is not None:
        seed = acc_seed.to(prod.dtype)
        if op.beta != 1.0:
            seed = seed * _acc_scalar(op.beta, op.pol)
        acc.value = acc.value + (-seed if op.neg_acc else seed)
    return acc.deprime(alpha=op.alpha, epilogue=op.epilogue, bias=op.bias,
                       residual=residual, out_dtype=op.out_dtype)


def _normalized_operands(op: Op, b, m, n):
    """acc/residual arrive in the spec's output shape; the 2-D lowerings
    want (M, N) — or (B, M, N) with the batch axis folded."""
    norm = (m, n) if b is None else (b, m, n)
    res2 = op.residual.reshape(norm) if op.residual is not None else None
    acc2 = op.acc.reshape(norm) if op.acc is not None else None
    return acc2, res2


# ----------------------------------------------------------------------
# gemm lowerings
# ----------------------------------------------------------------------

@register("kernel", "gemm")
@register("kernel", "gemm.masked")
def _lower_kernel_gemm(op: Op):
    """The Hopper GEMM kernel (kernels/mma_gemm.py): batch is the kernel's
    blockIdx.z — one launch per contraction — with accumulate forms, fused
    epilogues and expansion chains threading through unchanged.  A packed
    operand (one single-pass dispatch, admitted by ``_admit_packed``) goes
    through ``packing.refresh_gemm``, and its panels go to the wrapper with
    their layout: the wrapper takes the path its natural operands would,
    and that path reads them.  The masked
    op-class hands its pm* predicates to the same wrapper, which applies
    them while the kernel stages its panels (every pass of an expansion
    chain masked alike); the operands are never pre-masked."""
    x2, y2, (b, m, n, k), assemble = op.to_batched_2d()
    acc2, res2 = _normalized_operands(op, b, m, n)
    passes = _passes(op.ger, x2, y2)

    def one(kind, xi, yi, c, ep, out_dtype, *, forms=True, checksum=False):
        pol = precision.policy(kind)
        use_ep = not ep.is_identity
        xi, xl = _fresh_panels(xi.to(pol.x_dtype))
        yi, yl = _fresh_panels(yi.to(pol.y_dtype))
        if op.pinned is not None:
            block, tuned = None, op.pinned[kind]
        else:
            block, tuned = resolve_block(kind, m, n, k, op.block, ep.key,
                                         b=b or 1, device=xi.device.type)
        return _gemm.mma_gemm(
            xi, yi, c, kind=kind, block=block, tuned=tuned, x_layout=xl,
            y_layout=yl,
            masks=op.masks, neg_product=op.neg_product and forms,
            neg_acc=op.neg_acc and forms,
            alpha=op.alpha if forms else 1.0,
            beta=op.beta if forms else 1.0,
            ep=ep if use_ep else None,
            bias=op.bias if use_ep else None,
            residual=res2 if use_ep else None, out_dtype=out_dtype,
            checksum=checksum)

    if len(passes) == 1:
        xi, yi, kind = passes[0]
        slot = _abft.capture_slot()
        if slot is not None and op.masks is None:
            # ABFT-verified dispatch: the kernel sums each output tile's
            # columns and rows in its store (K1e) and the reduced vectors
            # go to the dispatcher's capture slot: no second read of the
            # output.
            out, ck_col, ck_row = one(kind, xi, yi, acc2, op.epilogue,
                                      op.out_dtype, checksum=True)
            _abft.deposit(slot, ck_col, ck_row)
            return assemble(out)
        return assemble(one(kind, xi, yi, acc2, op.epilogue, op.out_dtype))

    # Expansion chain (F32GER_3XBF16): the product accumulates across
    # passes through the kernel's seed; accumulate forms and the fused
    # epilogue then apply once, at deprime, on the chained product.
    identity_ep = Epilogue()
    if not op.fused and not op.has_forms:
        out = acc2       # plain: the C seed primes the first pass
        for xi, yi, kind in passes:
            out = one(kind, xi, yi, out, identity_ep, None, forms=False)
        return assemble(out.to(op.out_dtype))
    prod = None
    for xi, yi, kind in passes:
        prod = one(kind, xi, yi, prod, identity_ep, None, forms=False)
    return assemble(_combine_expanded(op, prod, acc2, res2))


def _fresh_panels(v):
    """``(tensor, layout)``: a natural tensor with None, a packed one's
    panels and layout (``packing.refresh_gemm``).  Which path they take,
    and whether it reads them, the wrapper decides, once."""
    if packing.is_packed(v):
        return packing.refresh_gemm(v)
    return v, None


@register("torch", "gemm")
def _lower_torch_gemm(op: Op):
    """Eager torch: one matmul per pass over the normalized operands, plus
    the explicit ACC lifecycle (packed operands demoted, counted)."""
    op = packing.demote_op(op, "torch-gemm")
    x2, y2, (b, m, n, k), assemble = op.to_batched_2d()
    acc2, res2 = _normalized_operands(op, b, m, n)
    passes = _passes(op.ger, x2, y2)
    if len(passes) == 1:
        xi, yi, kind = passes[0]
        pol = precision.policy(kind)
        acc = Accumulator(pol).prime(acc2, beta=op.beta, neg_acc=op.neg_acc)
        acc.update(xi.to(pol.x_dtype), yi.to(pol.y_dtype),
                   neg_product=op.neg_product)
        return assemble(acc.deprime(alpha=op.alpha, epilogue=op.epilogue,
                                    bias=op.bias, residual=res2,
                                    out_dtype=op.out_dtype))

    def plain(kind, xi, yi, c):
        pol = precision.policy(kind)
        acc = Accumulator(pol).prime(c)
        return acc.update(xi.to(pol.x_dtype), yi.to(pol.y_dtype)).value

    if not op.fused and not op.has_forms:
        out = acc2
        for xi, yi, kind in passes:
            out = plain(kind, xi, yi, out)
        return assemble(out.to(op.out_dtype))
    prod = None
    for xi, yi, kind in passes:
        prod = plain(kind, xi, yi, prod)
    return assemble(_combine_expanded(op, prod, acc2, res2))


@register("torch", "gemm.masked")
def _lower_torch_masked(op: Op):
    """pm* masked forms on the eager backend: the predicates fold into the
    operands as selects (``execute`` guarantees the natural layout, so the
    masks name the trailing axes) and the plain gemm lowering runs."""
    op = packing.demote_op(op, "torch-masked")
    x2, y2 = _gemm.select_masks(op.x, op.y, op.masks)
    return _lower_torch_gemm(dataclasses.replace(op, x=x2, y=y2, masks=None))


@register("ref", "gemm")
@register("ref", "gemm.masked")
def _lower_ref_gemm(op: Op):
    """Eager architected oracle: per-batch-element ref.ger, the ground
    truth the other backends are tested against (packed operands demoted,
    counted).  Masked ops fold their predicates into the normalized
    operands (the pm_ger oracle's semantics, by the kernels' selects)."""
    op = packing.demote_op(op, "ref-gemm")
    x2, y2, (b, m, n, k), assemble = op.to_batched_2d()
    x2, y2 = _gemm.select_masks(x2, y2, op.masks)
    acc2, res2 = _normalized_operands(op, b, m, n)
    passes = _passes(op.ger, x2, y2)

    def ger2d(xi, yi, kind, c):
        pol = precision.policy(kind)
        return _ref.ger(xi.to(pol.x_dtype), yi.to(pol.y_dtype), kind, acc=c)

    def chain(xi, yi, kind, c):
        if b is None:
            return ger2d(xi, yi, kind, c)
        return torch.stack([ger2d(xi[i], yi[i], kind,
                                  None if c is None else c[i])
                            for i in range(b)])

    if not op.fused and not op.has_forms:
        out = acc2
        for xi, yi, kind in passes:
            out = chain(xi, yi, kind, out)
        return assemble(out.to(op.out_dtype))
    prod = None
    for xi, yi, kind in passes:
        prod = chain(xi, yi, kind, prod)
    return assemble(_combine_expanded(op, prod, acc2, res2))


# ---- saturating accumulate forms (xvi16ger2s / xvi8ger4spp) ----------

_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _saturating_operands(op: Op):
    """The unpacked (M, K) x (K, N) operands of a saturating contraction
    and its rank r, after the refusals both lowerings share."""
    pol = op.pol
    if not pol.is_integer:
        raise ValueError("saturating forms are integer-only")
    x2, y2, (b, m, n, k), assemble = op.to_batched_2d()
    if b is not None:
        raise ValueError("saturating forms are 2-D only")
    x2, y2 = x2.to(pol.x_dtype), y2.to(pol.y_dtype)
    if pol.packed_int4:
        x2 = _ref.unpack_int4(x2)
        y2 = _ref.unpack_int4(y2.transpose(0, 1)).transpose(0, 1)
    r = pol.arch_rank
    if x2.shape[1] % r:
        raise ValueError(f"saturating {pol.ger.value} updates are rank {r}: "
                         f"K = {x2.shape[1]} is not a multiple")
    return x2, y2, (m, n), r, assemble


# Elements of the rank-r group products the torch lowering holds at once.
_SATURATING_CHUNK = 1 << 24


@register("torch", "gemm.saturating")
def _lower_torch_saturating(op: Op):
    """Clamped rank-r accumulation in eager torch: the rank-r group
    products a chunk of groups at a time, exact in float64 (|sum| <
    2**33), then a clamping scan over the groups in int64 -- each update's
    sum clamped to int32, as the instruction saturates."""
    x2, y2, (m, n), r, assemble = _saturating_operands(op)
    g = x2.shape[1] // r
    xg = x2.reshape(m, g, r).to(torch.float64)
    yg = y2.reshape(g, r, n).to(torch.float64)
    acc = (torch.zeros((m, n), dtype=torch.int64, device=x2.device)
           if op.acc is None else op.acc.reshape(m, n).to(torch.int32).to(
               torch.int64))
    step = max(1, _SATURATING_CHUNK // max(1, m * n))
    for g0 in range(0, g, step):
        prods = torch.einsum("mgr,grn->gmn", xg[:, g0:g0 + step],
                             yg[g0:g0 + step]).to(torch.int64)
        for p in prods:
            acc = (acc + p).clamp_(_I32_MIN, _I32_MAX)
    return assemble(acc.to(torch.int32).to(op.out_dtype))


@register("ref", "gemm.saturating")
def _lower_ref_saturating(op: Op):
    """Independent oracle: exact int64 group sums on the host, one group
    at a time, clamped per update."""
    x2, y2, (m, n), r, assemble = _saturating_operands(op)
    x64 = x2.cpu().to(torch.int64)
    y64 = y2.cpu().to(torch.int64)
    acc = (torch.zeros((m, n), dtype=torch.int64) if op.acc is None
           else op.acc.reshape(m, n).to(torch.int32).cpu().to(torch.int64))
    for g in range(x64.shape[1] // r):
        p = torch.matmul(x64[:, g * r:(g + 1) * r],
                         y64[g * r:(g + 1) * r, :])
        acc = (acc + p).clamp(_I32_MIN, _I32_MAX)
    return assemble(acc.to(torch.int32).to(x2.device).to(op.out_dtype))


# ---- complex op-class (complex matmul / DFT, paper section III) ------

def _parts(t):
    """(real, imag) of an operand as contiguous tensors: the strided
    ``.real``/``.imag`` views are copied once each, so the kernels read
    row-major panels; a real operand has zero imaginary part."""
    if t.is_complex():
        return t.real.contiguous(), t.imag.contiguous()
    return t, torch.zeros_like(t)


def _lower_complex(op: Op):
    """Complex contraction as the four real accumulate-form gers the paper
    composes (re <- re@re - im@im via the np form, im <- re@im + im@re via
    pp), run on whichever backend's gemm lowering this op resolved to, the
    kernel's included, batched specs too (the batched DFT)."""
    fn = lookup(op.backend, "gemm", op.ger, False)
    identity_ep = Epilogue()
    acc_dtype = op.pol.acc_dtype
    xr, xi = _parts(op.x)
    yr, yi = _parts(op.y)

    def ger(a, b, acc=None, neg=False):
        sub = dataclasses.replace(
            op, x=a, y=b, acc=acc, bias=None, residual=None,
            out_dtype=acc_dtype, epilogue=identity_ep, neg_product=neg,
            neg_acc=False, alpha=1.0, beta=1.0)
        return fn(sub)

    re = ger(xr, yr)
    re = ger(xi, yi, acc=re, neg=True)           # np accumulate form
    im = ger(xr, yi)
    im = ger(xi, yr, acc=im)                     # pp accumulate form

    # External accumulate forms, per component (as the Accumulator:
    # out = alpha * ([-]prod + beta * [-]C)).
    if op.neg_product:
        re, im = -re, -im
    if op.acc is not None:
        cr, ci = _parts(op.acc)
        cr, ci = cr.to(re.dtype), ci.to(im.dtype)
        if op.beta != 1.0:
            cr, ci = cr * op.beta, ci * op.beta
        if op.neg_acc:
            cr, ci = -cr, -ci
        re, im = re + cr, im + ci
    if op.alpha != 1.0:
        re, im = re * op.alpha, im * op.alpha
    od = op.out_dtype
    if od.is_complex:
        return torch.complex(re, im).to(od)
    # Real out_dtype: round each component to it, then re-embed (bf16/f16
    # have no complex pairing, so the container stays complex64).
    f = torch.float64 if od == torch.float64 else torch.float32
    return torch.complex(re.to(od).to(f), im.to(od).to(f))


for _b in BACKENDS:
    _REGISTRY[(_b, "complex", None, None)] = _lower_complex


# ----------------------------------------------------------------------
# conv lowerings
# ----------------------------------------------------------------------
# One shared geometry normalizer (the padding math is identical across
# backends), three lowerings: the conv kernels (K3 dense, K4 depthwise),
# eager torch convolutions, and the oracles of kernels/ref.py.

def _conv_norm(op: Op):
    """Normalize a conv invocation to padded NHWC x HWIO form.

    Returns ``(x4, w4, (sh, sw), depthwise, squeeze)``: 1-D specs gain a
    size-1 H axis (``squeeze`` strips it from the output), and the
    ``same``/``causal`` paddings become one explicit pad here so every
    backend sees identical VALID geometry.  A prepacked filter stream
    passes through untouched, its geometry read from its layout (a 1-D
    layout already carries the size-1 KH axis).
    """
    nd, depthwise = _CONV_SPECS[op.spec]
    x, w = op.x, op.y
    packed_w = packing.is_packed(w)
    if x.ndim != nd + 2 or w.ndim != nd + (1 if depthwise else 2):
        raise ValueError(f"conv spec {op.spec!r} got operands of shapes "
                         f"{tuple(x.shape)} x {tuple(w.shape)}")
    if nd == 1:
        x = x[:, None]                           # (N, 1, L, C)
        if not packed_w:
            w = w[None]                          # (1, KW, C[, F])
        strides = (1,) + op.stride
    else:
        strides = op.stride
    if packed_w:
        kh, kw, c = w.layout.kh, w.layout.kw, w.layout.c
    else:
        kh, kw, c = w.shape[0], w.shape[1], w.shape[2]
    if x.shape[-1] != c:
        raise ValueError(f"conv channel mismatch: image {tuple(op.x.shape)} "
                         f"vs filter {tuple(op.y.shape)}")
    pads = []
    for k, st, size in zip((kh, kw), strides, x.shape[1:3]):
        if op.padding == "valid":
            lo = hi = 0
        elif op.padding == "same":
            out = -(-size // st)
            total = max((out - 1) * st + k - size, 0)
            lo, hi = total // 2, total - total // 2
        elif op.padding == "causal":       # left pad: output t sees <= t
            if nd != 1:
                raise ValueError(
                    "causal padding is 1-D (time-axis) vocabulary; "
                    f"spec {op.spec!r} is 2-D")
            lo, hi = k - 1, 0
        else:
            raise ValueError(f"unknown conv padding {op.padding!r}; "
                             f"want valid | same | causal")
        pads.append((lo, hi))
    if any(p != (0, 0) for p in pads):
        # F.pad lists the last dim first: C, then W, then H
        x = torch.nn.functional.pad(x, (0, 0) + pads[1] + pads[0])
    return x, w, strides, depthwise, nd == 1


@contextlib.contextmanager
def _cudnn_fp32():
    """cuDNN runs fp32 convolutions in TF32 by default; F32GER is true
    fp32, so the torch conv lowering turns TF32 off for its own calls."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@register("kernel", "conv")
def _lower_kernel_conv(op: Op):
    """The Hopper conv kernels (kernels/mma_conv.py): the dense specs run
    K3's implicit GEMM, the depthwise spec K4, expansion chain included:
    conv is bilinear, so the F32GER_3XBF16 hi/lo passes sum over one
    accumulator and the epilogue applies once on the chained product.  An
    explicit ``Plan.block`` names K3's filter tile (its N tile, as the
    reference takes ``block[1]``) and changes no result; K4 has none.
    Else the GEMM winner at (OW, F, KW*C), as the reference consults it,
    applies its filter tile where K3 has one (``tiling.conv_tuned``).  A
    packed filter stream (single-pass dense specs only: ``_admit_packed``)
    goes through ``packing.refresh_conv`` to the wrapper, which takes the
    path the natural filter would, and whose kernels read it on every
    path."""
    x4, w4, strides, depthwise, squeeze = _conv_norm(op)
    if depthwise:
        if op.block is not None:
            raise ValueError("the depthwise kernel has no tile to choose; "
                             f"got block {op.block!r}")
        conv = _conv.mma_depthwise_conv2d
    else:
        if op.block is not None and len(op.block) != 3:
            raise ValueError(f"conv blocks are (bm, bf, bk) like the gemm's; "
                             f"got {op.block!r}")
        if packing.is_packed(w4):
            kh, kw, c, f = (w4.layout.kh, w4.layout.kw, w4.layout.c,
                            w4.layout.f)
        else:
            kh, kw, c, f = w4.shape
        ow = (x4.shape[2] - kw) // strides[1] + 1
        tuned = op.pinned
        if op.block is None and tuned is None:
            _, won = resolve_block(op.ger, ow, f, kw * c, None,
                                   op.epilogue.key,
                                   device=x4.device.type)
            tuned = (tiling.conv_tuned(won, rep_kind(op.ger))
                     if won is not None else None)
        conv = functools.partial(
            _conv.mma_conv2d,
            bf=op.block[1] if op.block is not None else None, tuned=tuned)
    res = op.residual
    if res is not None and squeeze:
        res = res[:, None]
    passes = _passes(op.ger, x4, w4)
    if len(passes) == 1:
        xi, wi, kind = passes[0]
        pk = precision.policy(kind)
        xi, wi = xi.to(pk.x_dtype), wi.to(pk.y_dtype)
        kw = {}
        if packing.is_packed(wi):
            wi, kw["w_layout"] = packing.refresh_conv(wi)
        out = conv(xi, wi, stride=strides, out_dtype=op.out_dtype,
                   ep=op.epilogue, bias=op.bias, residual=res, **kw)
        return out[:, 0] if squeeze else out
    prod = None
    for xi, wi, kind in passes:
        pk = precision.policy(kind)
        o = conv(xi.to(pk.x_dtype), wi.to(pk.y_dtype), stride=strides,
                 out_dtype=op.pol.acc_dtype)
        prod = o if prod is None else prod + o
    prod = _epilogue_mod.apply(prod, op.epilogue, bias=op.bias, residual=res)
    if squeeze:
        prod = prod[:, 0]
    return prod.to(op.out_dtype)


def torch_conv(x4, w4, strides, depthwise: bool, acc_dtype):
    """One eager torch convolution of a padded NHWC image and HWIO (or
    depthwise HWC) filters, both up-cast to the accumulator dtype, with
    cuDNN's TF32 off: the accumulator-dtype NHWC result.  One pass of the
    torch conv lowering, and the backward of the conv kernels' Functions,
    which differentiate this recomputation."""
    xi = x4.to(acc_dtype).permute(0, 3, 1, 2)
    wi = w4.to(acc_dtype)
    with _cudnn_fp32():
        if depthwise:                     # (KH, KW, C) -> (C, 1, KH, KW)
            o = torch.nn.functional.conv2d(
                xi, wi.permute(2, 0, 1)[:, None], stride=strides,
                groups=wi.shape[2])
        else:                             # (KH, KW, C, F) -> (F, C, KH, KW)
            o = torch.nn.functional.conv2d(xi, wi.permute(3, 2, 0, 1),
                                           stride=strides)
    return o.permute(0, 2, 3, 1)          # NCHW -> NHWC


@register("torch", "conv")
def _lower_torch_conv(op: Op):
    """One eager torch convolution per architected pass
    (:func:`torch_conv`), then the epilogue at deprime.  Per pass, the
    inputs are rounded to that pass family's operand dtype and up-cast to
    the accumulator dtype for the conv itself, as a reduced-precision pass
    into a wide accumulator (packed filters demoted, counted)."""
    op = packing.demote_op(op, "torch-conv")
    x4, w4, strides, depthwise, squeeze = _conv_norm(op)
    out = None
    for xi, wi, kind in _passes(op.ger, x4, w4):
        pk = precision.policy(kind)
        o = torch_conv(xi.to(pk.x_dtype), wi.to(pk.y_dtype), strides,
                       depthwise, op.pol.acc_dtype)
        out = o if out is None else out + o
    if squeeze:
        out = out[:, 0]
    out = _epilogue_mod.apply(out, op.epilogue, bias=op.bias,
                              residual=op.residual)
    return out.to(op.out_dtype)


@register("ref", "conv")
def _lower_ref_conv(op: Op):
    """The oracles: the materialized-Abar ``ref.conv2d`` (exactly the
    patch matrix a kernel avoids building) and the eager shift-and-sum
    ``ref.depthwise_conv``.  Expansion hooks chain per pass like the gemm
    oracle (packed filters demoted, counted)."""
    op = packing.demote_op(op, "ref-conv")
    x4, w4, strides, depthwise, squeeze = _conv_norm(op)
    acc_dtype = op.pol.acc_dtype
    out = None
    for xi, wi, kind in _passes(op.ger, x4, w4):
        pk = precision.policy(kind)
        xi, wi = xi.to(pk.x_dtype), wi.to(pk.y_dtype)
        if depthwise:
            o = _ref.depthwise_conv(xi, wi, stride=strides,
                                    acc_dtype=acc_dtype)
        else:
            o = _ref.conv2d(xi, wi, stride=strides)
        o = o.to(acc_dtype)
        out = o if out is None else out + o
    if squeeze:
        out = out[:, 0]
    out = _epilogue_mod.apply(out, op.epilogue, bias=op.bias,
                              residual=op.residual)
    return out.to(op.out_dtype)


# ----------------------------------------------------------------------
# attn lowerings
# ----------------------------------------------------------------------
# Three lowerings over one convention: causal/window/q_offset/valid are
# structural predicates on the score tile; rows whose every slot is masked
# yield exact zeros.

@register("kernel", "attn")
def _lower_kernel_attn(op: Op):
    """The Hopper flash kernel (kernels/mma_attention.py): persistent
    blocks over the (b, h, q tile) tiles, GQA by index, the causal/window
    bounds computed per tile, short queries split over KV.  A Plan.block
    names the q tile, (128, 64) or (64, 64); else a cached winner (keyed
    by heads, not by batch: ``autotune.lookup_attn``) names the q tile and
    the split; else the wrapper's heuristic picks them."""
    tiles = ((_attn.BLOCK_Q, _attn.BLOCK_K), (_attn.BLOCK_Q_SHORT,
                                              _attn.BLOCK_K))
    if op.block is not None and tuple(op.block) not in tiles:
        raise ValueError(f"the attention kernel's tiles are {tiles}, not "
                         f"{tuple(op.block)}")
    pol = op.pol
    _, sq, h, d = op.x.shape
    if op.pinned is not None:
        tuned = op.pinned
    elif op.block is not None:
        tuned = (op.block[0], None)
    else:
        tuned = _autotune.lookup_attn(op.ger, h, sq, op.y.shape[1], d,
                                      op.epilogue.key,
                                      backend=op.x.device.type)
    return _attn.mma_flash_attention(
        op.x.to(pol.x_dtype), op.y.to(pol.x_dtype), op.z.to(pol.y_dtype),
        causal=op.causal, q_offset=op.q_offset, window=op.window,
        valid=op.valid, ep=op.epilogue, bias=op.bias, residual=op.residual,
        out_dtype=op.out_dtype, tuned=tuned)


def attend_chunk(q, k, v, *, q_pos, kv_pos, causal, window, valid):
    """One query chunk against full K/V — THE chunked-attention math,
    shared by the torch attn lowering below and by ``layers.sdpa``'s
    ring-buffer decode path.

    q (B, C, H, D) with K/V already head-repeated; ``q_pos`` (1|B, C) and
    ``kv_pos`` (1|B, Sk) absolute positions; ``valid`` (1|B, Sk) or None.
    Returns the fp32 result; rows whose every slot is masked yield exact
    zeros.  Scores are fp32 products of the input-dtype operands, and P is
    rounded to v's dtype before the value product, as in the reference.
    """
    s = torch.einsum("bchd,bkhd->bhck", q.float(), k.float())
    s = s * (q.shape[-1] ** -0.5)
    mask = torch.ones((1, q_pos.shape[-1], kv_pos.shape[-1]),
                      dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    if valid is not None:
        mask = mask & valid[:, None, :]
    s = torch.where(mask[:, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    # fully-masked rows: softmax degenerates to uniform mean(V); zero them
    p = torch.where(mask.any(-1)[:, None, :, None], p, torch.zeros_like(p))
    return torch.einsum("bhck,bkhd->bchd", p.to(v.dtype).float(), v.float())


def torch_attention(q, k, v, *, causal, window, q_offset, valid,
                    q_chunk=0, ep=None, bias=None, residual=None,
                    out_dtype=None):
    """Chunked two-product attention in eager torch ops on q (B, Sq, H, D)
    and k, v (B, Sk, KVH, D) of the family's input dtypes: a loop over
    query chunks bounds live scores to (B, H, chunk, Sk), ragged tail
    chunk included; then the epilogue and the cast.  The torch attn
    lowering, and the backward of the attention kernel's Function, which
    differentiates this recomputation."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = repeat_kv(k, h // k.shape[2])
    v = repeat_kv(v, h // v.shape[2])
    valid = (valid.to(torch.bool).reshape(-1, sk)
             if valid is not None else None)
    pos = (torch.arange(sq, device=q.device) + q_offset)[None]
    kv_pos = torch.arange(sk, device=q.device)[None]
    chunk = min(q_chunk or ATTN_Q_CHUNK, sq)
    out = torch.cat([
        attend_chunk(q[:, s:s + chunk], k, v, q_pos=pos[:, s:s + chunk],
                     kv_pos=kv_pos, causal=causal, window=window,
                     valid=valid)
        for s in range(0, sq, chunk)], dim=1)
    out = _epilogue_mod.apply(out, ep, bias=bias, residual=residual)
    return out.to(out_dtype or q.dtype)


@register("torch", "attn")
def _lower_torch_attn(op: Op):
    """Eager chunked attention (:func:`torch_attention`)."""
    pol = op.pol
    return torch_attention(
        op.x.to(pol.x_dtype), op.y.to(pol.x_dtype), op.z.to(pol.y_dtype),
        causal=op.causal, window=op.window, q_offset=op.q_offset,
        valid=op.valid, q_chunk=op.q_chunk, ep=op.epilogue, bias=op.bias,
        residual=op.residual, out_dtype=op.out_dtype)


@register("ref", "attn")
def _lower_ref_attn(op: Op):
    """The two-product oracle (kernels/mma_attention.ref_attention), then
    the epilogue."""
    pol = op.pol
    out = _attn.ref_attention(
        op.x.to(pol.x_dtype), op.y.to(pol.x_dtype), op.z.to(pol.y_dtype),
        causal=op.causal, window=op.window, q_offset=op.q_offset,
        valid=op.valid)
    out = _epilogue_mod.apply(out, op.epilogue, bias=op.bias,
                              residual=op.residual)
    return out.to(op.out_dtype)


# ---- general einsum fallback -----------------------------------------

@register("torch", "einsum")
@register("ref", "einsum")
def _lower_einsum(op: Op):
    """Specs the GEMM normalizer rejects (diagonals, sum-reductions):
    policy-cast inputs, accumulator-dtype arithmetic, one einsum."""
    pol = op.pol
    if op.acc is not None or op.fused or op.has_forms:
        raise ValueError(
            f"spec {op.spec!r} is not GEMM-shaped; accumulate forms and "
            f"fused epilogues need a gemm-class contraction")
    x = op.x.to(pol.x_dtype).to(pol.acc_dtype)
    y = op.y.to(pol.y_dtype).to(pol.acc_dtype)
    return torch.einsum(op.spec, x, y).to(op.out_dtype)


# ----------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------

def _check_attn(x, y, z, ger, plan, acc, dequant, masks):
    """Validate an ATTN contraction; returns the valid-slot predicate."""
    if z is None:
        raise ValueError(
            f"the attn spec {ATTN!r} is a three-operand contraction: "
            f"contract(facility.ATTN, q, k, v, ...)")
    if x.ndim != 4 or y.ndim != 4 or y.shape != z.shape:
        raise ValueError(
            f"attn wants q (B, Sq, H, D) and k == v shapes (B, Sk, KVH, D); "
            f"got {tuple(x.shape)} x {tuple(y.shape)} x {tuple(z.shape)}")
    b, sq, h, d = x.shape
    bk_, sk, kvh, dk_ = y.shape
    if bk_ != b or dk_ != d or h % kvh:
        raise ValueError(
            f"attn batch/head/depth mismatch: q {tuple(x.shape)} vs "
            f"k/v {tuple(y.shape)} (H must be a multiple of KVH)")
    if ger not in _ATTN_GERS:
        raise ValueError(
            f"attn lowers float families with f32 accumulators only "
            f"({[g.value for g in _ATTN_GERS]}), not {ger.value}")
    if (acc is not None or dequant is not None or plan.saturating
            or plan.neg_product or plan.neg_acc or plan.alpha != 1.0
            or plan.beta != 1.0):
        raise ValueError(
            "attn contractions take no accumulator seed, dequant, "
            "saturating, or alpha/beta/neg accumulate forms — only a fused "
            "epilogue and the causal/window/q_offset/valid predicates")
    if plan.block is not None and len(plan.block) != 2:
        raise ValueError(f"attn blocks are (bq, bk); got {plan.block!r}")
    if plan.window is not None and plan.window < 1:
        raise ValueError(f"window must be >= 1, got {plan.window!r}")
    if masks is None:
        return None
    if len(masks) != 1:
        raise ValueError(
            "attn masks is the 1-tuple (valid,) — the (B, Sk) "
            f"filled-KV-slot predicate — got {len(masks)} entries")
    valid = masks[0]
    if valid is not None and tuple(valid.shape) not in ((sk,), (1, sk),
                                                        (b, sk)):
        raise ValueError(f"attn valid mask has shape {tuple(valid.shape)}; "
                         f"want ({sk},) or ({b}, {sk})")
    return valid


def _check_masks(spec, parsed, op_class, pol, x, y, masks, dequant) -> str:
    """Validate the pm* predicates of a gemm contraction (the reference's
    checks and messages); returns the ``gemm.masked`` op-class."""
    if len(masks) != 3:
        raise ValueError(
            f"masks wants the 3-tuple (xmask, ymask, pmask) — entries "
            f"may be None — got {len(masks)} entries")
    if op_class != "gemm":
        raise ValueError(
            f"masks (pm* prefixed forms) require a gemm-class "
            f"contraction, not {op_class!r} ({spec!r})")
    if not parsed.is_natural_gemm:
        raise ValueError(
            f"masked contraction {spec!r} must already be in the "
            f"normalized (batch..., M, K) x (batch..., K, N) layout "
            f"so the (M,), (N,), (K,) predicates name unique axes")
    if dequant is not None:
        raise ValueError("masks and dequant are exclusive")
    if pol.packed_int4:
        raise ValueError(
            "packed-int4 masked forms lower through the ref.pm_ger "
            "oracle (ops.mma_pm_dot keeps that path)")
    sizes = _sizes(parsed, x, y)
    want = (sizes[parsed.x_free[0]], sizes[parsed.y_free[0]],
            sizes[parsed.contract[0]])
    for i, mask in enumerate(masks):
        if mask is None:
            continue
        if tuple(mask.shape) != (want[i],):
            raise ValueError(
                f"mask {i} has shape {tuple(mask.shape)}; want "
                f"({want[i]},) for spec {spec!r}")
        if mask.device != x.device:
            raise ValueError(f"mask {i} on {mask.device}, operands on "
                             f"{x.device}")
    return "gemm.masked"


# ----------------------------------------------------------------------
# Packed-operand admission: which operands may stay in their prepacked
# layout for this dispatch (core/packing.py owns the layouts; this layer
# reads descriptor metadata and demotes the rest through packing's
# counted demotion)
# ----------------------------------------------------------------------

def _packed_gemm_compatible(parsed, v, side: str) -> bool:
    """A packed GEMM operand is admissible when the spec's normalization
    of that operand is exactly the relayout its pack already paid: one
    contract label, one free label on the packed side, at most one batch
    label, and a label order matching the layout's orientation."""
    lay = v.layout
    if lay.tile != "gemm" or lay.side != side:
        return False
    p = parsed
    if p is None or len(p.contract) != 1 or len(p.batch) > 1:
        return False
    free = p.x_free if side == "x" else p.y_free
    if len(free) != 1 or lay.batched != bool(p.batch):
        return False
    labels = p.x_labels if side == "x" else p.y_labels
    if side == "x":
        natural = p.batch + free + p.contract
        flipped = p.batch + p.contract + free
    else:
        natural = p.batch + p.contract + free
        flipped = p.batch + free + p.contract
    return labels == (flipped if lay.transposed else natural)


def _admit_packed(op_class: str, backend: str, pol, parsed, spec: str,
                  x, y, dequantized: bool):
    """Demote the packed operands that cannot ride this dispatch packed.

    Packed operands ride the single-pass kernel gemm and dense conv
    lowerings (whose every path reads them: a gemm both operands' panels
    at once, where the reference demotes x) and reach the torch/ref gemm
    and conv lowerings, which demote them themselves; everything else --
    the other op-classes, expansion chains, int4 nibble families, a spec
    orientation the pack did not pay -- demotes here, once, counted.  A
    quantized operand (raw int8 panels) demotes only where the dispatch
    applies its scale (``dequantized``: a Dequant deprime); elsewhere
    ``packing.demote_value`` refuses it."""
    kernel_ok = (backend == "kernel" and not pol.packed_int4
                 and pol.ger not in _EXPANSIONS)
    dq = {"dequantized": dequantized}
    if op_class in ("gemm", "gemm.masked") and kernel_ok:
        if packing.is_packed(x) and not _packed_gemm_compatible(
                parsed, x, "x"):
            x = packing.demote_value(x, "spec-orientation", **dq)
        if packing.is_packed(y) and not _packed_gemm_compatible(
                parsed, y, "y"):
            y = packing.demote_value(y, "spec-orientation", **dq)
        return x, y
    if op_class == "conv" and kernel_ok:
        if packing.is_packed(x):
            x = packing.demote_value(x, "conv-image-operand", **dq)
        if packing.is_packed(y):
            nd, depthwise = _CONV_SPECS[spec]
            lay = y.layout
            if depthwise or lay.tile != "conv" or lay.nd != nd:
                y = packing.demote_value(y, "conv-layout-mismatch", **dq)
        return x, y
    if op_class in ("gemm", "gemm.masked", "conv") \
            and backend in ("torch", "ref"):
        if dequantized:
            # the lowering's demote_op does not see the Dequant: demote
            # here, for the same reason
            why = f"{backend}-{op_class}"
            return (packing.demote_value(x, why, **dq),
                    packing.demote_value(y, why, **dq))
        return x, y
    return (packing.demote_value(x, op_class, **dq),
            packing.demote_value(y, op_class, **dq))


# ----------------------------------------------------------------------
# Guarded dispatch: the kernel -> torch -> ref degradation ladder
# ----------------------------------------------------------------------
# Opt-in via FacilityConfig(guards=True): contract outputs pass a NaN/Inf
# detector, and lowering failures (an unsupported shape, an injected fault)
# demote down the ladder.  Each demotion is logged and quarantined per
# (op-class, ger, spec, shapes), so a poisoned configuration is demoted
# ONCE, not retried on every call.  With guards off the dispatch tail is
# bit for bit the unguarded facility's (tests/test_torch_guards.py).

LADDER = ("kernel", "torch", "ref")

# Exception classes a lowering legitimately raises for an operand it cannot
# take (narrow on purpose: programming errors such as AttributeError must
# surface, not demote).  faults.InjectedFault is the fault harness's
# stand-in for all of them.  RuntimeError is NOT here, unlike the
# reference's jax runtime error: a CUDA kernel that fails to build or
# launch raises RuntimeError (kernels/_build.check) or
# torch.AcceleratorError, and demoting it would be the hidden fallback the
# port forbids, so it raises under guards too.
LOWERING_ERRORS = (ValueError, TypeError, NotImplementedError,
                   ArithmeticError)

_QUARANTINE: dict[tuple, str] = {}     # guard key -> demoted start rung
GUARD_EVENTS: list[dict] = []          # demotion log (tests/CI assert)
_guard_log = logging.getLogger("repro_torch.facility.guards")


def guard_key(op_class: str, op: Op) -> tuple:
    """Quarantine granularity: one entry per (op-class, ger, spec, operand
    shapes), the granularity the autotune cache keys a kernel config by."""
    return (op_class, op.ger.value, op.spec, tuple(op.x.shape),
            tuple(op.y.shape))


def quarantine_state() -> dict:
    return dict(_QUARANTINE)


def clear_guard_state() -> None:
    _QUARANTINE.clear()
    GUARD_EVENTS.clear()
    _abft.clear_verdicts()


def _output_finite(out) -> bool:
    """The NaN/Inf detector (one device sync per guarded dispatch)."""
    if out.is_complex():
        return bool(torch.isfinite(torch.view_as_real(out)).all())
    if not out.is_floating_point():
        return True
    return bool(torch.isfinite(out).all())


def _record_demotion(key, frm, to, reason, op_class, spec):
    ev = {"op_class": op_class, "spec": spec, "from": frm, "to": to,
          "reason": reason, "key": key}
    GUARD_EVENTS.append(ev)
    _guard_log.warning("guard: %s %r demoted %s -> %s (%s)",
                       op_class, spec, frm, to, reason)


def _apply_data_fault(fault, out):
    """Apply the data-shaped fault kinds to a lowering output."""
    if fault is None:
        return out
    if fault.kind == _faults.NAN:
        return _faults.poison(out)
    if fault.kind == _faults.FLIP:
        return _faults.flip(out, fault.seed)
    return out


def _guarded_dispatch(op: Op, op_class: str, backend: str, ger: Ger,
                      fused: bool, abft_on: bool = False, wrap=None):
    """Walk the ladder from ``backend`` (or its quarantined demotion)
    until a rung returns a clean output.

    Demotion rules, the reference's:
      * a rung that *raises* (LOWERING_ERRORS / InjectedFault) is
        quarantined immediately — the failure is structural;
      * a rung whose output is non-finite is demoted *pending*: the
        quarantine commits only if a later rung produces finite output
        (otherwise the NaN is input-borne and no rung is at fault);
      * the final rung's non-finite output is returned as-is, without
        quarantine — ref is ground truth;
      * with ABFT on (``core/abft.py``) a rung whose output fails checksum
        verification is retried ONCE on the same rung (transient SDC
        clears), then demoted *pending* like the non-finite case; the
        final rung's mismatch is returned as-is with an unrecovered
        verdict on ``abft.VERDICTS``.

    A verdict's ``detail`` is the check that detected the mismatch (the
    dispatch's first failed check, on the rung it started from, so a
    kernel-rung detection carries ``"sidecar": True``), where the
    reference records the last rung's (or none for a demotion).
    ``wrap`` (a mesh dispatch's :func:`_shard_wrap`) runs each rung per
    shard: demotions and checksum verdicts stay whole-dispatch decisions.
    """
    key = guard_key(op_class, op)
    start = _QUARANTINE.get(key, backend)
    if start not in LADDER:
        start = backend
    attempts = [r for r in LADDER[LADDER.index(start):]
                if lookup(r, op_class, ger, fused) is not None]
    if not attempts:
        raise NotImplementedError(
            f"no lowering registered on any ladder rung for "
            f"({op_class!r}, {ger}, fused={fused})")
    aplan = None
    if abft_on:
        conv_dw = (op_class == "conv"
                   and _CONV_SPECS.get(op.spec, (0, False))[1])
        aplan = _abft.plan_for(op, op_class, expanded=ger in _EXPANSIONS,
                               conv_depthwise=conv_dw)

    def attempt(fn, sub):
        """One guarded execution: inject, run (checksum-instrumented when a
        verification plan is active), apply data-shaped faults.  Returns
        (out, raw, cap): ``out`` the caller-visible output, ``raw`` what
        verification checks (the augmented checksum channel intact), ``cap``
        the kernel sidecar's capture."""
        fault = _faults.maybe_inject(_faults.CONTRACT_DISPATCH)
        runner = wrap(fn) if wrap is not None else fn
        cap = None
        if aplan is not None and aplan.augments:
            raw = runner(aplan.augment(sub))
        elif aplan is not None:
            with _abft.capture() as cap:
                raw = runner(sub)
        else:
            raw = runner(sub)
        raw = _apply_data_fault(fault, raw)
        out = aplan.strip(raw) if aplan is not None and aplan.augments \
            else raw
        return out, raw, cap

    last_exc = None
    pending_nonfinite = False
    pending_mismatch = False
    detected = None            # the first failed check's detail
    for i, rung in enumerate(attempts):
        fn = lookup(rung, op_class, ger, fused)
        sub = op if rung == op.backend \
            else dataclasses.replace(op, backend=rung)
        nxt = attempts[i + 1] if i + 1 < len(attempts) else None
        try:
            out, raw, cap = attempt(fn, sub)
        except (_faults.InjectedFault,) + LOWERING_ERRORS as e:
            last_exc = e
            if nxt is None:
                raise
            _record_demotion(key, rung, nxt, f"{type(e).__name__}: {e}",
                             op_class, op.spec)
            _QUARANTINE[key] = nxt
            continue
        if not _output_finite(out):
            if nxt is None:
                # ref itself is non-finite: input-borne NaN, nobody's fault
                DISPATCH_COUNTS[(rung, op_class, ger.value)] += 1
                return out
            pending_nonfinite = True
            _record_demotion(key, rung, nxt, "non-finite output",
                             op_class, op.spec)
            continue
        if aplan is not None:
            ok, detail = aplan.check(raw, cap)
            if not ok:
                detected = detected or detail
                # Retry the SAME rung once: a one-shot upset clears; the
                # retry consults the fault plan again, so max_fires-bounded
                # injections clear like the hardware fault they stand for.
                retried = None
                try:
                    retried = attempt(fn, sub)
                except (_faults.InjectedFault,) + LOWERING_ERRORS as e:
                    last_exc = e
                if retried is not None:
                    out2, raw2, cap2 = retried
                    if _output_finite(out2) and aplan.check(raw2, cap2)[0]:
                        _abft.record_verdict(
                            key=key, op_class=op_class, spec=op.spec,
                            rung=rung, recovered=True, how="retry",
                            detail=detected)
                        if rung != backend and (pending_nonfinite
                                                or pending_mismatch):
                            _QUARANTINE[key] = rung
                        DISPATCH_COUNTS[(rung, op_class, ger.value)] += 1
                        return out2
                if nxt is None:
                    # ground truth disagrees with its own checksums: return
                    # it, but tell the serving loop (it discards the step
                    # and requeues the slots).
                    _abft.record_verdict(
                        key=key, op_class=op_class, spec=op.spec,
                        rung=rung, recovered=False, how="exhausted",
                        detail=detected)
                    DISPATCH_COUNTS[(rung, op_class, ger.value)] += 1
                    return retried[0] if retried is not None else out
                pending_mismatch = True
                _record_demotion(key, rung, nxt, "checksum-mismatch",
                                 op_class, op.spec)
                continue
        if rung != backend and (pending_nonfinite or pending_mismatch):
            # data-borne demotions commit only on a clean lower rung
            _QUARANTINE[key] = rung
        if pending_mismatch:
            _abft.record_verdict(
                key=key, op_class=op_class, spec=op.spec, rung=rung,
                recovered=True, how="demote", detail=detected)
        DISPATCH_COUNTS[(rung, op_class, ger.value)] += 1
        return out
    raise last_exc  # pragma: no cover — the loop returns or raises


# ----------------------------------------------------------------------
# Shard-aware dispatch: the mesh path.  When a mesh binding resolves
# (Plan.mesh or the ambient parallel.api rules), the kernel gemm/conv/attn
# lowerings run PER SHARD: output-disjoint labels (batch, M, N, heads, Sq)
# map onto mesh axes, every shard keeps the FULL contraction extent, and
# everything that picks the arithmetic (the GEMM path and its config: the
# stream's K partition, the wgmma tile, the IMMA form; the attention tile
# and KV split; the conv path; an autotune winner) is resolved once at the
# global shape and pinned for every shard, so each shard runs exactly the
# sums the single-device dispatch would: the sharded output is the
# single-device output bit for bit.  The guarded ladder and ABFT wrap the
# per-shard run from outside, with the kernel sidecar's capture masked
# inside it (abft.suppress), so the global checksums carry verification.
# ----------------------------------------------------------------------

_SHARD_OPERANDS = ("x", "y", "z", "acc", "bias", "residual", "valid")


def _shard_rules(plan: Plan):
    """Resolve ``Plan.mesh`` to the active ShardingRules, or None when
    this dispatch stays single-device (no binding, ``mesh=False``, or a
    rules object with no mesh behind it)."""
    b = plan.mesh
    if b is False or isinstance(b, _par.BankShard):
        return None
    if b is None:
        r = _par.current()
        return r if (r.enabled and r.mesh is not None) else None
    if isinstance(b, _par.ShardingRules):
        return b if b.mesh is not None else None
    return _par.default_rules(b)


@dataclasses.dataclass(frozen=True)
class _ShardPlan:
    """How one dispatch maps onto the mesh: a spec per operand present
    (by ``_SHARD_OPERANDS`` name), the output's spec, the plan pinned at
    the global shape, and for causal/window sequence-parallel attention
    the mesh axes whose flattened index gives the rank's ``q_offset``."""

    specs: dict
    out_spec: tuple
    pinned: object = None
    seq_axes: tuple = ()
    seq_local: int = 0


def _local_shape(shape, spec, rules) -> tuple:
    return tuple(n // rules.axis_extent(ax) if ax is not None else n
                 for n, ax in zip(shape, spec))


def _gemm_extent(op: Op, assign=None, rules=None) -> tuple:
    """(b, m, n, k) of a gemm ``op`` (b None when unbatched); with a
    label -> mesh axis ``assign``, one shard's."""
    p = op.parsed
    sizes = _sizes(p, op.x, op.y)
    ext = [_prod(sizes[d] // (rules.axis_extent(assign.get(d))
                              if assign else 1) for d in labels)
           for labels in (p.batch, p.x_free, p.y_free, p.contract)]
    return (ext[0] if p.batch else None, *ext[1:])


def _pin_gemm(op: Op, b, m, n, k, ml=None, nl=None):
    """``{kind: (path, config)}``: the GEMM path and config the wrapper
    would choose for the kernel gemm ``op`` at the global product (b, m,
    n, k), pinned as every shard's ``tuned`` (the mesh's shards, the
    exchange's banks); None when a shard of ``ml`` x ``nl`` cannot take
    it."""
    kind = rep_kind(op.ger)
    pol = precision.policy(kind)
    ib = pol.x_dtype.itemsize

    def base_ok(t, dtype):
        # the dispatch's operand as the wrapper sees it: a cast or a
        # gathered DTensor is a fresh allocation, a view keeps its base
        return (_par.is_dtensor(t) or t.dtype != dtype
                or not t.is_contiguous() or t.data_ptr() % 16 == 0)

    x_ok = (k * ib) % 16 == 0 and base_ok(op.x, pol.x_dtype)
    aligned = (x_ok and (n * ib) % 16 == 0 and base_ok(op.y, pol.y_dtype)
               and not (packing.is_packed(op.x) or packing.is_packed(op.y)))
    block, tuned = resolve_block(kind, m, n, k, op.block, op.epilogue.key,
                                 b=b or 1, device=op.x.device.type)
    pin = tiling.choose_gemm_path(m, n, k, kind, b or 1, aligned, block,
                                  False, tuned, x_ok)
    # each shard must run the global plan: its rows stay aligned where the
    # global rows are (a sliced-out shard is a fresh copy), its column
    # pitch is its own
    ml, nl = ml or m, nl or n
    if not tiling.takes(pin, ml, nl, k, kind, aligned and (nl * ib) % 16
                        == 0, False, x_ok):
        return None
    return {kind: pin}


def _plan_gemm_shards(op: Op, rules) -> _ShardPlan | None:
    """Bind gemm labels to mesh axes: batch labels ride the data axes
    (any packed operand vetoes: its panels cannot be sliced), M rows take
    the data axes otherwise, N columns take the TP axis when the y side is
    natural.  Contraction labels are never sharded: every shard reduces
    the full K.  The path is resolved at the global (b, m, n, k) and must
    be one each shard's product can take, else the dispatch stays
    single-device."""
    p = op.parsed
    sizes = _sizes(p, op.x, op.y)
    x_packed = packing.is_packed(op.x)
    y_packed = packing.is_packed(op.y)
    dp = rules.rules.get("batch")
    tp = rules.rules.get("mlp") or rules.rules.get("heads")
    assign: dict = {}
    used: list = []

    def bind(labels, ax, veto) -> bool:
        if ax is None or veto or not labels:
            return False
        e = rules.axis_extent(ax)
        if e <= 1 or any(a in used for a in _par.flat_axes(ax)):
            return False
        for d in labels:
            if sizes[d] % e == 0:
                assign[d] = ax
                used.extend(_par.flat_axes(ax))
                return True
        return False

    if not bind(p.batch, dp, x_packed or y_packed):
        bind(p.x_free, dp, x_packed)
    # bias is flat over the normalized N: its contiguous shard chunks line
    # up with output columns only when the OUTERMOST y_free label is the
    # sharded one.
    bind(p.y_free[:1] if op.bias is not None else p.y_free, tp, y_packed)
    if not assign:
        return None

    def spec_for(labels):
        return tuple(assign.get(d) for d in labels)

    specs = {"x": () if x_packed else spec_for(p.x_labels),
             "y": () if y_packed else spec_for(p.y_labels)}
    out_spec = spec_for(p.out_labels)
    if op.acc is not None:
        specs["acc"] = out_spec
    if op.residual is not None:
        specs["residual"] = out_spec
    if op.bias is not None:
        specs["bias"] = (assign.get(p.y_free[0]),)

    pinned = None
    if op.backend == "kernel":
        (b, m, n, k), (_, ml, nl, _) = (
            _gemm_extent(op), _gemm_extent(op, assign, rules))
        pinned = _pin_gemm(op, b, m, n, k, ml, nl)
        if pinned is None:
            return None
    return _ShardPlan(specs=specs, out_spec=out_spec, pinned=pinned)


def _plan_conv_shards(op: Op, rules) -> _ShardPlan | None:
    """Conv shards the image batch N over the data axes; filters and bias
    stay resident (replicated).  The dense conv's path is resolved at the
    global image and pinned; the depthwise plan does not read N."""
    dp = rules.rules.get("batch")
    e = rules.axis_extent(dp)
    n = op.x.shape[0]
    if e <= 1 or n % e:
        return None
    img = (dp,) + (None,) * (op.x.ndim - 1)
    specs = {"x": img, "y": ()}
    if op.bias is not None:
        specs["bias"] = ()
    if op.residual is not None:
        specs["residual"] = img
    pinned = None
    nd, depthwise = _CONV_SPECS[op.spec]
    if op.backend == "kernel" and not depthwise and op.block is None:
        x4, w4, strides, _, _ = _conv_norm(op)
        pk = precision.policy(op.ger)
        if op.ger in _EXPANSIONS:
            return _ShardPlan(specs=specs, out_spec=img)
        if packing.is_packed(w4):
            kh, kw, c, f = (w4.layout.kh, w4.layout.kw, w4.layout.c,
                            w4.layout.f)
        else:
            kh, kw, c, f = w4.shape
        ow = (x4.shape[2] - kw) // strides[1] + 1
        _, won = resolve_block(op.ger, ow, f, kw * c, None, op.epilogue.key,
                               device=x4.device.type)
        tuned = (tiling.conv_tuned(won, rep_kind(op.ger))
                 if won is not None else None)
        pinned = _conv.conv_path(x4.to(pk.x_dtype), kh, kw, c, f, strides,
                                 None, f % 8 == 0, tuned)
    return _ShardPlan(specs=specs, out_spec=img, pinned=pinned)


def _plan_attn_shards(op: Op, rules) -> _ShardPlan | None:
    """Attn shards B over the data axes and heads over TP, but only when
    BOTH q heads and kv heads divide (each shard keeps the full GQA group
    ratio); otherwise Sq goes sequence-parallel over the seq rules entry,
    with K/V resident.  A causal/window sequence shard runs at its own
    ``q_offset``: the rank's index along those axes times its rows.  The
    (q tile, KV split) plan is resolved at the global shape and pinned."""
    b, sq, h, d = op.x.shape
    kvh = op.y.shape[2]
    sk = op.y.shape[1]
    dp = rules.rules.get("batch")
    hp = rules.rules.get("heads")
    sqp = rules.rules.get("seq")
    q = [None, None, None, None]
    kv = [None, None, None, None]
    used: list = []
    seq_axes: tuple = ()
    seq_local = 0

    def free(ax) -> bool:
        return (ax is not None and rules.axis_extent(ax) > 1
                and not any(a in used for a in _par.flat_axes(ax)))

    if free(dp) and b % rules.axis_extent(dp) == 0:
        q[0] = kv[0] = dp
        used.extend(_par.flat_axes(dp))
    if free(hp) and h % rules.axis_extent(hp) == 0 \
            and kvh % rules.axis_extent(hp) == 0:
        q[2] = kv[2] = hp
        used.extend(_par.flat_axes(hp))
    elif free(sqp) and sq % rules.axis_extent(sqp) == 0:
        q[1] = sqp
        used.extend(_par.flat_axes(sqp))
        if op.causal or op.window is not None:
            seq_axes, seq_local = _par.flat_axes(sqp), sq // rules.axis_extent(sqp)
    if all(a is None for a in q):
        return None
    specs = {"x": tuple(q), "y": tuple(kv), "z": tuple(kv)}
    if op.residual is not None:
        specs["residual"] = tuple(q)
    if op.bias is not None:
        specs["bias"] = ()
    if op.valid is not None:
        specs["valid"] = ((dp, None) if q[0] is not None
                          and op.valid.ndim == 2 and op.valid.shape[0] == b
                          else ())
    pinned = None
    if op.backend == "kernel":
        f32 = op.pol.x_dtype == torch.float32
        if op.block is not None:
            tuned = (op.block[0], None)
        else:
            tuned = _autotune.lookup_attn(op.ger, h, sq, sk, d,
                                          op.epilogue.key,
                                          backend=op.x.device.type)
        bq, n_split, _ = _attn.attn_plan(b, h, sq, sk, d, f32, tuned)
        pinned = (bq, n_split)
        lq = _local_shape(op.x.shape, q, rules)[1]
        if not _attn.attn_takes(pinned, lq, sk, d, f32):
            return None
    return _ShardPlan(specs=specs, out_spec=tuple(q), pinned=pinned,
                      seq_axes=seq_axes, seq_local=seq_local)


def _shard_plan(op: Op, op_class: str, rules) -> _ShardPlan | None:
    if op_class == "gemm":
        return _plan_gemm_shards(op, rules)
    if op_class == "conv":
        return _plan_conv_shards(op, rules)
    if op_class == "attn":
        return _plan_attn_shards(op, rules)
    return None


def _shard_wrap(op_class: str, rules, op0: Op, sp0: _ShardPlan):
    """``fn -> per-shard fn``: the mesh path's one wrapper (``shard_map``'s
    counterpart).

    ``run(sub)`` takes ``sp0``, the plan :func:`execute` made, for the op
    it was made for (``op0``) and plans any other op it is given (the
    guarded ladder may hand it another rung's op, or an ABFT-augmented
    one; an op with no plan runs whole), slices every operand to this
    rank's shard
    (``parallel.api.enter``: a DTensor operand, a sharded parameter, is
    gathered or sliced to the plan's spec, its gradient reduced back),
    runs ``fn`` on the local op with the pinned plan and, for a
    sequence-parallel causal/window attention, this rank's ``q_offset``,
    and gathers the output (``parallel.api.leave``).  The ``collective``
    fault point fires once a sharded dispatch."""
    mesh = rules.mesh
    names = list(_par.axis_sizes(mesh))

    def wrap(fn):
        def run(sub: Op):
            sp = sp0 if sub is op0 else _shard_plan(sub, op_class, rules)
            if sp is None:
                return fn(sub)
            _faults.maybe_inject(_faults.COLLECTIVE)
            out_axes = {a for ax in sp.out_spec if ax is not None
                        for a in _par.flat_axes(ax)}
            kw = {}
            for name, spec in sp.specs.items():
                v = getattr(sub, name)
                if v is None:
                    continue
                if packing.is_packed(v):
                    kw[name] = v
                    continue
                spec = spec or (None,) * v.ndim
                own = {a for ax in spec if ax is not None
                       for a in _par.flat_axes(ax)}
                partial = frozenset(names.index(a) for a in out_axes - own)
                kw[name] = _par.enter(v, spec, mesh, partial)
            q_offset = sub.q_offset
            if sp.seq_axes:
                idx = 0
                coord = mesh.get_coordinate()
                for a in sp.seq_axes:
                    i = names.index(a)
                    idx = idx * tuple(mesh.shape)[i] + coord[i]
                q_offset += idx * sp.seq_local
            inner = dataclasses.replace(
                sub, pinned=sp.pinned if sub.backend == "kernel" else None,
                q_offset=q_offset, **kw)
            with _abft.suppress():
                out = fn(inner)
            return _par.leave(out, sp.out_spec, mesh)
        return run
    return wrap


def _mesh_dispatch(op: Op, op_class: str, plan: Plan):
    """``(op, wrap)`` for a dispatch in a process with a torch.distributed
    world: a kernel gemm/conv/attn whose binding resolves to a mesh and
    plans onto it runs per shard (``wrap``, :func:`_shard_wrap`); an
    exchange's bank (``parallel.api.BankShard``) is pinned to the whole
    bank's plan; any other dispatch with a DTensor operand (a sharded
    parameter) runs on its global value."""
    if op.backend == "kernel" and op_class in ("gemm", "conv", "attn"):
        srules = _shard_rules(plan)
        sp = _shard_plan(op, op_class, srules) if srules is not None \
            else None
        if sp is not None:
            return op, _shard_wrap(op_class, srules, op, sp)
        if op_class == "gemm" and isinstance(plan.mesh, _par.BankShard):
            b, m, n, k = _gemm_extent(op)
            if b is not None:
                op = dataclasses.replace(op, pinned=_pin_gemm(
                    op, b * plan.mesh.factor, m, n, k))
    held = {n: _par.full(getattr(op, n)) for n in _SHARD_OPERANDS
            if _par.is_dtensor(getattr(op, n))}
    return (dataclasses.replace(op, **held) if held else op), None


def execute(spec: str, x, y, z=None, *, cfg, plan: Plan | None = None,
            acc=None, bias=None, residual=None,
            dequant: Dequant | None = None, masks=None):
    """Resolve ``plan`` against ``cfg``, pick a lowering, run it.

    This is the body of ``facility.contract``.  ``z`` is the value operand
    of the canonical ``ATTN`` spec; for attn, ``masks`` is the 1-tuple
    ``(valid,)`` KV-slot predicate, for a gemm the pm* 3-tuple
    ``(xmask, ymask, pmask)`` on the natural M/N/K axes (each entry
    optional), which routes to the ``gemm.masked`` op-class.  ``dequant``
    rescales the accumulator-dtype result after the lowering (the quant
    path), then the cast to the out dtype.  Every operand must lie on the
    facility's device: a CPU tensor never runs a CUDA-configured facility.
    """
    plan = plan or Plan()
    ger = plan.ger or cfg.ger
    pol = precision.policy(ger)
    if isinstance(plan.out_dtype, str) and plan.out_dtype == ACC:
        out_dtype = pol.acc_dtype
    else:
        out_dtype = plan.out_dtype or cfg.out_dtype
    backend = plan.backend or cfg.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    for t in (x, y, z, acc, bias, residual):
        if t is not None and t.device.type != cfg.device.type:
            raise ValueError(
                f"contract operand on {t.device}, but the facility runs on "
                f"{cfg.device}")

    ep = plan.epilogue
    if ep is None:
        ep = make_epilogue(bias=bias, residual=residual)
    ep.validate(pol.acc_dtype, bias=bias, residual=residual)

    spec = spec.replace(" ", "")
    parsed = None
    valid = None
    stride: tuple = ()
    if z is not None and spec != ATTN:
        raise ValueError(f"a third operand is attn-spec vocabulary "
                         f"(facility.ATTN), not {spec!r}")
    if spec == ATTN:
        op_class = "attn"
        valid = _check_attn(x, y, z, ger, plan, acc, dequant, masks)
        masks = None
    elif spec in _CONV_SPECS:
        nd, _ = _CONV_SPECS[spec]
        op_class = "conv"
        s = plan.stride
        stride = (s,) * nd if isinstance(s, int) else tuple(s)
        if len(stride) != nd or any(st < 1 for st in stride):
            raise ValueError(f"conv spec {spec!r} wants {nd} stride "
                             f"value(s) >= 1, got {plan.stride!r}")
        if (acc is not None or dequant is not None or plan.saturating
                or plan.neg_product or plan.neg_acc or plan.alpha != 1.0
                or plan.beta != 1.0):
            raise ValueError(
                "conv contractions take no accumulator seed, dequant, "
                "saturating, or alpha/beta/neg accumulate forms — only a "
                "fused epilogue")
    elif any(isinstance(t, torch.Tensor) and t.is_complex()
             for t in (x, y)):
        op_class = "complex"
        parsed = parse_spec(spec, x.ndim, y.ndim)
        if parsed is None or parsed.out_perm is not None:
            raise ValueError(
                f"complex contraction {spec!r} must normalize to a "
                f"(batched) GEMM in natural output order")
        if dequant is not None or plan.saturating or not ep.is_identity:
            raise ValueError(
                "complex contractions take accumulate forms only — no "
                "fused epilogue, dequant, or saturating updates")
    else:
        parsed = parse_spec(spec, x.ndim, y.ndim)
        if parsed is not None and _ellipsis_broadcasts(parsed, x, y):
            parsed = None
        if plan.saturating and parsed is None:
            raise ValueError(f"saturating forms need a GEMM-shaped spec, "
                             f"not {spec!r}")
        op_class = "gemm.saturating" if plan.saturating else (
            "gemm" if parsed is not None else "einsum")
    if masks is not None:
        op_class = _check_masks(spec, parsed, op_class, pol, x, y, masks,
                                dequant)
    if op_class != "conv" and (plan.stride != 1 or plan.padding != "valid"):
        raise ValueError(
            f"stride/padding apply to the conv specs only, not {spec!r}")
    if op_class != "attn" and (plan.causal or plan.window is not None
                               or plan.q_offset or plan.q_chunk):
        raise ValueError(
            f"causal/window/q_offset/q_chunk apply to the attn spec only, "
            f"not {spec!r}")
    if dequant is not None and not ep.is_identity:
        raise ValueError("dequant and a fused epilogue are exclusive")
    if (parsed is not None and parsed.out_perm is not None
            and (acc is not None or not ep.is_identity)):
        raise ValueError(
            f"spec {spec!r} permutes the natural output order; accumulator "
            f"inputs and fused epilogues require the natural "
            f"(batch..., m..., n...) output")
    if plan.saturating and (not ep.is_identity or plan.neg_product
                            or plan.neg_acc or plan.alpha != 1.0
                            or plan.beta != 1.0 or dequant is not None):
        raise ValueError(
            "saturating forms take an accumulator seed only — no fused "
            "epilogue, dequant, or alpha/beta/neg accumulate forms "
            "(xvi16ger2s-class instructions have no such variants)")

    if (op_class == "conv" and backend == "kernel"
            and pol.acc_dtype != torch.float32):
        # The conv kernels accumulate in f32 only: a family with another
        # accumulator goes to the torch lowering by its Ger, statically
        # (as the reference sends it to xla), not as a failure fallback.
        backend = "torch"

    fn = lookup(backend, op_class, ger, not ep.is_identity)
    if fn is None and backend == "kernel":
        # general einsum specs and the saturating forms have no kernel
        # (the reference sent them to xla the same way): a static route by
        # op-class, not a failure fallback
        backend = "torch"
        fn = lookup(backend, op_class, ger, not ep.is_identity)
    if fn is None:
        raise NotImplementedError(
            f"no lowering registered for ({backend!r}, {op_class!r}, "
            f"{ger}, fused={not ep.is_identity})")
    x, y = _admit_packed(op_class, backend, pol, parsed, spec, x, y,
                         dequant is not None)
    op = Op(x=x, y=y, acc=acc, bias=bias, residual=residual, parsed=parsed,
            spec=spec, ger=ger, pol=pol, masks=masks,
            out_dtype=pol.acc_dtype if dequant is not None else out_dtype,
            epilogue=ep, block=plan.block, neg_product=plan.neg_product,
            neg_acc=plan.neg_acc, alpha=plan.alpha, beta=plan.beta,
            z=z, valid=valid, causal=plan.causal,
            window=plan.window, q_offset=plan.q_offset,
            q_chunk=plan.q_chunk, stride=stride, padding=plan.padding,
            backend=backend)
    # with no torch.distributed world there is no mesh and no DTensor:
    # one call, and the single-device dispatch goes on
    op, wrap = _mesh_dispatch(op, op_class, plan) if _par.active() \
        else (op, None)
    if cfg.guards:
        out = _guarded_dispatch(op, op_class, backend, ger, not ep.is_identity,
                                abft_on=cfg.abft, wrap=wrap)
    else:
        # The unguarded path: with no fault plan installed this is ONE
        # contextvar read away from fn(op), bit for bit.
        DISPATCH_COUNTS[(backend, op_class, ger.value)] += 1
        fault = _faults.maybe_inject(_faults.CONTRACT_DISPATCH)
        out = _apply_data_fault(fault, wrap(fn)(op) if wrap is not None
                                else fn(op))
    if dequant is not None:
        out = dequant.apply(out).to(out_dtype)
    return out


def deprecated_shim(old: str, replacement: str):
    """Emit the facility-migration DeprecationWarning for a legacy entry
    point (kernels/ops.py).  stacklevel=3 attributes the warning to the
    shim's caller."""
    warnings.warn(
        f"{old} is deprecated; use facility.contract — e.g. {replacement}",
        DeprecationWarning, stacklevel=3)
