"""The lowering registry beneath ``facility.contract`` (port of
``repro.core.lowering``: the gemm, conv, attn and einsum parts).

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
    ``"conv"`` (the canonical NHWC conv specs, stride and valid/same/causal
    padding in the Plan), ``"attn"`` (the canonical three-operand ATTN
    spec), ``"einsum"`` (general contraction fallback, eager on every
    backend, as the reference's einsum fell to xla).  ``gemm.masked``,
    ``gemm.saturating`` and ``complex`` are later slices and raise
    ``NotImplementedError`` naming theirs.
  * ``ger``/``fused``: optional specializations; lookup falls back from the
    most specific key to ``(backend, op_class, None, None)``.

There is no guarded ladder yet (ROADMAP slice D1): a kernel that fails to
build or launch raises, it never demotes silently to another backend.

ACC lifecycle
-------------
Every gemm-class lowering implements the same three-phase accumulator
lifecycle (paper fig. 4 — prime, rank-k updates, deprime):

    prime    acc <- 0 | [-] beta * C
    update   acc <- acc [-] X_i @ Y_i         (one per rank-k pass)
    deprime  out <- cast(epilogue(alpha * acc))

The CUDA kernel realizes it in registers and shared memory
(csrc/mma_gemm.cu); the torch and ref lowerings with the explicit
:class:`Accumulator`.  The ``F32GER_3XBF16`` expansion hook rewrites one
fp32 pass into three chained bf16 passes over one accumulator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from repro_torch.core import precision
from repro_torch.kernels import epilogue as _epilogue_mod
from repro_torch.kernels import mma_attention as _attn
from repro_torch.kernels import mma_conv as _conv
from repro_torch.kernels import mma_gemm as _gemm
from repro_torch.kernels import ref as _ref

Ger = precision.Ger

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
    saturating: bool = False          # gemm.saturating: slice C2
    # Conv op-class only (spec is one of the canonical conv specs below):
    stride: object = 1                # int, or one value per spatial dim
    padding: str = "valid"            # valid | same | causal
    # Attn op-class only (spec is the canonical ATTN spec below):
    causal: bool = False              # q attends k with k_pos <= q_pos
    window: int | None = None         # sliding window: q_pos - k_pos < window
    q_offset: int = 0                 # absolute position of q[0]
    q_chunk: int = 0                  # torch lowering's q-chunk (0 = default)


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

# The ROADMAP slice that brings each op-class or family this slice lacks.
_LATER = {
    "gemm.masked": "the pm* masked forms (ROADMAP queue 2, K1b)",
    "gemm.saturating": "saturating accumulation (ROADMAP slice C2)",
    "complex": "complex contractions (ROADMAP slice C1)",
    "integer": "the integer families (ROADMAP queue 2, K1c/K1f; slice C3)",
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{_LATER[what]} is not ported yet")


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
            v = v * beta
        self.value = -v if neg_acc else v
        return self

    def update(self, x, y, *, neg_product: bool = False):
        """acc <- acc [-] X @ Y, accumulating in the family's acc dtype."""
        prod = torch.matmul(x.to(self.pol.acc_dtype),
                            y.to(self.pol.acc_dtype))
        if neg_product:
            prod = -prod
        self.value = prod if self.value is None else prod + self.value
        return self

    def deprime(self, *, alpha: float = 1.0, epilogue=None, bias=None,
                residual=None, out_dtype=None):
        out = self.value
        if alpha != 1.0:
            out = out * alpha
        out = _epilogue_mod.apply(out, epilogue, bias=bias,
                                  residual=residual)
        return out.to(out_dtype) if out_dtype is not None else out


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------

_REGISTRY: dict[tuple, object] = {}
_EXPANSIONS: dict[Ger, tuple[Ger, object]] = {}

BACKENDS = ("kernel", "torch", "ref")


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
            seed = seed * op.beta
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
def _lower_kernel_gemm(op: Op):
    """The Hopper GEMM kernel (kernels/mma_gemm.py): batch is the kernel's
    blockIdx.z — one launch per contraction — with accumulate forms, fused
    epilogues and expansion chains threading through unchanged."""
    x2, y2, (b, m, n, k), assemble = op.to_batched_2d()
    acc2, res2 = _normalized_operands(op, b, m, n)
    passes = _passes(op.ger, x2, y2)

    def one(kind, xi, yi, c, ep, out_dtype, *, forms=True):
        pol = precision.policy(kind)
        use_ep = not ep.is_identity
        return _gemm.mma_gemm(
            xi.to(pol.x_dtype), yi.to(pol.y_dtype), c, kind=kind,
            block=op.block,
            neg_product=op.neg_product and forms,
            neg_acc=op.neg_acc and forms,
            alpha=op.alpha if forms else 1.0,
            beta=op.beta if forms else 1.0,
            ep=ep if use_ep else None,
            bias=op.bias if use_ep else None,
            residual=res2 if use_ep else None, out_dtype=out_dtype)

    if len(passes) == 1:
        xi, yi, kind = passes[0]
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


@register("torch", "gemm")
def _lower_torch_gemm(op: Op):
    """Eager torch: one matmul per pass over the normalized operands, plus
    the explicit ACC lifecycle."""
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


@register("ref", "gemm")
def _lower_ref_gemm(op: Op):
    """Eager architected oracle: per-batch-element ref.ger, the ground
    truth the other backends are tested against."""
    x2, y2, (b, m, n, k), assemble = op.to_batched_2d()
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
    backend sees identical VALID geometry.
    """
    nd, depthwise = _CONV_SPECS[op.spec]
    x, w = op.x, op.y
    if x.ndim != nd + 2 or w.ndim != nd + (1 if depthwise else 2):
        raise ValueError(f"conv spec {op.spec!r} got operands of shapes "
                         f"{tuple(x.shape)} x {tuple(w.shape)}")
    if nd == 1:
        x = x[:, None]                           # (N, 1, L, C)
        w = w[None]                              # (1, KW, C[, F])
        strides = (1,) + op.stride
    else:
        strides = op.stride
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
    reference takes ``block[1]``) and changes no result; K4 has none."""
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
        conv = functools.partial(
            _conv.mma_conv2d,
            bf=op.block[1] if op.block is not None else None)
    res = op.residual
    if res is not None and squeeze:
        res = res[:, None]
    passes = _passes(op.ger, x4, w4)
    if len(passes) == 1:
        xi, wi, kind = passes[0]
        pk = precision.policy(kind)
        out = conv(xi.to(pk.x_dtype), wi.to(pk.y_dtype), stride=strides,
                   out_dtype=op.out_dtype, ep=op.epilogue, bias=op.bias,
                   residual=res)
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


@register("torch", "conv")
def _lower_torch_conv(op: Op):
    """One eager torch convolution per architected pass, then the epilogue
    at deprime.  Per pass, the inputs are rounded to that pass family's
    operand dtype and up-cast to the accumulator dtype for the conv
    itself, as a reduced-precision pass into a wide accumulator."""
    x4, w4, strides, depthwise, squeeze = _conv_norm(op)
    acc_dtype = op.pol.acc_dtype
    out = None
    with _cudnn_fp32():
        for xi, wi, kind in _passes(op.ger, x4, w4):
            pk = precision.policy(kind)
            xi = xi.to(pk.x_dtype).to(acc_dtype).permute(0, 3, 1, 2)
            wi = wi.to(pk.y_dtype).to(acc_dtype)
            if depthwise:                 # (KH, KW, C) -> (C, 1, KH, KW)
                o = torch.nn.functional.conv2d(
                    xi, wi.permute(2, 0, 1)[:, None], stride=strides,
                    groups=wi.shape[2])
            else:                         # (KH, KW, C, F) -> (F, C, KH, KW)
                o = torch.nn.functional.conv2d(
                    xi, wi.permute(3, 2, 0, 1), stride=strides)
            o = o.permute(0, 2, 3, 1)     # NCHW -> NHWC
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
    oracle."""
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
    """The Hopper flash kernel (kernels/mma_attention.py): one block per
    (b, h, q tile), GQA by index, the causal/window bounds computed per
    block, short queries split over KV.  The wrapper picks the tile; a
    Plan.block names the prefill tile or nothing."""
    if op.block is not None and tuple(op.block) != (_attn.BLOCK_Q,
                                                    _attn.BLOCK_K):
        raise ValueError(f"the attention kernel's tile is "
                         f"({_attn.BLOCK_Q}, {_attn.BLOCK_K}), not "
                         f"{tuple(op.block)}")
    pol = op.pol
    return _attn.mma_flash_attention(
        op.x.to(pol.x_dtype), op.y.to(pol.x_dtype), op.z.to(pol.y_dtype),
        causal=op.causal, q_offset=op.q_offset, window=op.window,
        valid=op.valid, ep=op.epilogue, bias=op.bias, residual=op.residual,
        out_dtype=op.out_dtype)


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


@register("torch", "attn")
def _lower_torch_attn(op: Op):
    """Chunked two-product attention: a loop over query chunks bounds live
    scores to (B, H, chunk, Sk), ragged tail chunk included."""
    pol = op.pol
    q = op.x.to(pol.x_dtype)
    k = op.y.to(pol.x_dtype)
    v = op.z.to(pol.y_dtype)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = repeat_kv(k, h // k.shape[2])
    v = repeat_kv(v, h // v.shape[2])
    valid = (op.valid.to(torch.bool).reshape(-1, sk)
             if op.valid is not None else None)
    pos = (torch.arange(sq, device=q.device) + op.q_offset)[None]
    kv_pos = torch.arange(sk, device=q.device)[None]
    chunk = min(op.q_chunk or ATTN_Q_CHUNK, sq)
    out = torch.cat([
        attend_chunk(q[:, s:s + chunk], k, v, q_pos=pos[:, s:s + chunk],
                     kv_pos=kv_pos, causal=op.causal, window=op.window,
                     valid=valid)
        for s in range(0, sq, chunk)], dim=1)
    out = _epilogue_mod.apply(out, op.epilogue, bias=op.bias,
                              residual=op.residual)
    return out.to(op.out_dtype)


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

def _check_attn(x, y, z, ger, plan, acc, masks):
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
    if (acc is not None or plan.saturating or plan.neg_product
            or plan.neg_acc or plan.alpha != 1.0 or plan.beta != 1.0):
        raise ValueError(
            "attn contractions take no accumulator seed, saturating, or "
            "alpha/beta/neg accumulate forms — only a fused epilogue and "
            "the causal/window/q_offset/valid predicates")
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


def execute(spec: str, x, y, z=None, *, cfg, plan: Plan | None = None,
            acc=None, bias=None, residual=None, masks=None):
    """Resolve ``plan`` against ``cfg``, pick a lowering, run it.

    This is the body of ``facility.contract``.  ``z`` is the value operand
    of the canonical ``ATTN`` spec; for attn, ``masks`` is the 1-tuple
    ``(valid,)`` KV-slot predicate.  Every operand must lie on the
    facility's device: a CPU tensor never runs a CUDA-configured facility.
    """
    plan = plan or Plan()
    ger = plan.ger or cfg.ger
    pol = precision.policy(ger)
    if pol.is_integer:
        raise _later("integer")
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
        valid = _check_attn(x, y, z, ger, plan, acc, masks)
        masks = None
    elif spec in _CONV_SPECS:
        nd, _ = _CONV_SPECS[spec]
        op_class = "conv"
        s = plan.stride
        stride = (s,) * nd if isinstance(s, int) else tuple(s)
        if len(stride) != nd or any(st < 1 for st in stride):
            raise ValueError(f"conv spec {spec!r} wants {nd} stride "
                             f"value(s) >= 1, got {plan.stride!r}")
        if (acc is not None or plan.saturating or plan.neg_product
                or plan.neg_acc or plan.alpha != 1.0 or plan.beta != 1.0):
            raise ValueError(
                "conv contractions take no accumulator seed, saturating, "
                "or alpha/beta/neg accumulate forms — only a fused "
                "epilogue")
    elif x.is_complex() or y.is_complex():
        raise _later("complex")
    elif plan.saturating:
        raise _later("gemm.saturating")
    else:
        parsed = parse_spec(spec, x.ndim, y.ndim)
        if parsed is not None and _ellipsis_broadcasts(parsed, x, y):
            parsed = None
        op_class = "gemm" if parsed is not None else "einsum"
    if masks is not None:
        raise _later("gemm.masked")
    if op_class != "conv" and (plan.stride != 1 or plan.padding != "valid"):
        raise ValueError(
            f"stride/padding apply to the conv specs only, not {spec!r}")
    if op_class != "attn" and (plan.causal or plan.window is not None
                               or plan.q_offset or plan.q_chunk):
        raise ValueError(
            f"causal/window/q_offset/q_chunk apply to the attn spec only, "
            f"not {spec!r}")
    if (parsed is not None and parsed.out_perm is not None
            and (acc is not None or not ep.is_identity)):
        raise ValueError(
            f"spec {spec!r} permutes the natural output order; accumulator "
            f"inputs and fused epilogues require the natural "
            f"(batch..., m..., n...) output")

    if (op_class == "conv" and backend == "kernel"
            and pol.acc_dtype != torch.float32):
        # The conv kernels accumulate in f32 only: a family with another
        # accumulator goes to the torch lowering by its Ger, statically
        # (as the reference sends it to xla), not as a failure fallback.
        backend = "torch"

    fn = lookup(backend, op_class, ger, not ep.is_identity)
    if fn is None and backend == "kernel":
        # general einsum specs have no kernel (the reference sent them to
        # xla the same way): a static route, not a failure fallback
        backend = "torch"
        fn = lookup(backend, op_class, ger, not ep.is_identity)
    if fn is None:
        raise NotImplementedError(
            f"no lowering registered for ({backend!r}, {op_class!r}, "
            f"{ger}, fused={not ep.is_identity})")
    op = Op(x=x, y=y, acc=acc, bias=bias, residual=residual, parsed=parsed,
            spec=spec, ger=ger, pol=pol, out_dtype=out_dtype, epilogue=ep,
            block=plan.block, neg_product=plan.neg_product,
            neg_acc=plan.neg_acc, alpha=plan.alpha, beta=plan.beta,
            z=z, valid=valid, causal=plan.causal,
            window=plan.window, q_offset=plan.q_offset,
            q_chunk=plan.q_chunk, stride=stride, padding=plan.padding)
    return fn(op)
