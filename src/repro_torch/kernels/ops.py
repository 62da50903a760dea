"""Kernel-level entry points: thin deprecated shims over
``facility.contract`` (port of ``repro.kernels.ops``).

The dispatch these names once owned (kernel or eager, the F32GER_3XBF16
three-pass split) lives in the lowering registry (``core.lowering``):
``mma_dot``, ``mma_dot_fused``, ``mma_pm_dot`` and ``mma_conv2d`` survive
as shims that warn (``DeprecationWarning``) and call ``contract``, so
callers of the reference's kernel-level surface keep working.  The
reference's ``use_pallas``/``interpret`` pair becomes ``backend``:
``"kernel"`` (the Hopper kernels; their plain versions on a CPU tensor),
``"torch"`` or ``"ref"``, as ``FacilityConfig.backend`` names them.
``mma_ger_saturating`` (the clamped accumulate forms) stays the supported
builtin for the one operation no ``contract`` spec names: it runs the
``gemm.saturating`` op-class on the torch lowering, where the reference
ran it on xla.  ``mma_pm_dot`` lowers the prefixed masked forms through
the ``gemm.masked`` op-class, except I4GER8, which ``contract`` refuses:
with a column mask alone it runs the IMMA kernel's column predicate
(``mma_gemm(masks=(None, ymask, None))``), and with a row or rank mask
it keeps the ``ref.pm_ger`` oracle (nibble unpacking and rank predicates
do not compose in the kernels), as the reference does for every I4GER8
call.

``_resolve_block`` is the reference's dispatch-time autotune consult, kept
for tooling: the block a GEMM at these operands' shape would run
(explicit, else the cached winner's, else None: the heuristic), read
through the registry's ``lowering.resolve_block``.
"""

from __future__ import annotations

import torch

from repro_torch.core import autotune, facility, lowering, precision
from repro_torch.kernels import mma_gemm as _gemm
from repro_torch.kernels import ref as _ref

Ger = precision.Ger
Epilogue = facility.Epilogue

_GEMM = "mk,kn->mn"


def _resolve_block(x, y, kind: Ger, block: tuple[int, int, int] | None,
                   epilogue_key: str = "none", backend: str = "kernel"):
    """Dispatch-time autotune-cache consult (delegates to the registry's
    resolver): an explicit ``block``, else the (bm, bn, bk) of the cached
    winner for x (M, K) @ y (K, N) on their device
    (``autotune.block_of``), else None."""
    if block is not None or backend != "kernel":
        return block
    pack = 2 if precision.policy(kind).packed_int4 else 1
    m, k = x.shape[0], x.shape[1] * pack
    n = y.shape[1]
    _, tuned = lowering.resolve_block(kind, m, n, k, None, epilogue_key,
                                      device=x.device.type)
    return autotune.block_of(tuned) if tuned is not None else None


def _plan(kind, block, backend, out_dtype, *, epilogue=None,
          neg_product=False, neg_acc=False, alpha=1.0, beta=1.0,
          saturating=False) -> facility.Plan:
    return facility.Plan(
        ger=kind, block=block, backend=backend,
        out_dtype=out_dtype if out_dtype is not None else facility.ACC,
        epilogue=epilogue, neg_product=neg_product, neg_acc=neg_acc,
        alpha=alpha, beta=beta, saturating=saturating)


def mma_dot(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor | None = None,
            *, kind: Ger = Ger.BF16GER2,
            block: tuple[int, int, int] | None = None,
            backend: str = "kernel", out_dtype=None) -> torch.Tensor:
    """Deprecated: ``facility.contract("mk,kn->mn", x, y, acc=c,
    plan=Plan(ger=kind, ...))``.

    ``C <- X @ Y [+ C]`` under a ger-kind policy; x (M, K), y (K, N); the
    accumulator dtype unless ``out_dtype`` names another.
    """
    lowering.deprecated_shim(
        "ops.mma_dot", 'contract("mk,kn->mn", x, y, acc=c, '
        "plan=Plan(ger=kind, backend=..., block=...))")
    return facility.contract(_GEMM, x, y, acc=c,
                             plan=_plan(kind, block, backend, out_dtype))


def mma_dot_fused(x: torch.Tensor, y: torch.Tensor,
                  c: torch.Tensor | None = None, *,
                  kind: Ger = Ger.BF16GER2,
                  epilogue: Epilogue | None = None,
                  bias: torch.Tensor | None = None,
                  residual: torch.Tensor | None = None,
                  block: tuple[int, int, int] | None = None,
                  backend: str = "kernel",
                  neg_product: bool = False, neg_acc: bool = False,
                  alpha: float = 1.0, beta: float = 1.0,
                  out_dtype=None) -> torch.Tensor:
    """Deprecated: ``facility.contract`` with an epilogue-carrying Plan.

    ``mma_dot`` with the fused epilogue (bias, activation, residual) and
    the pp/np/pn/nn accumulate forms of the registry's ACC lifecycle.
    """
    lowering.deprecated_shim(
        "ops.mma_dot_fused", 'contract("mk,kn->mn", x, y, acc=c, '
        "plan=Plan(ger=kind, epilogue=ep, alpha=..., beta=...), "
        "bias=..., residual=...)")
    epilogue = epilogue or lowering.make_epilogue(bias=bias,
                                                  residual=residual)
    return facility.contract(
        _GEMM, x, y, acc=c, bias=bias, residual=residual,
        plan=_plan(kind, block, backend, out_dtype, epilogue=epilogue,
                   neg_product=neg_product, neg_acc=neg_acc, alpha=alpha,
                   beta=beta))


def mma_ger_saturating(x: torch.Tensor, y: torch.Tensor,
                       kind: Ger = Ger.I16GER2,
                       acc: torch.Tensor | None = None) -> torch.Tensor:
    """Saturating accumulation forms (xvi16ger2s / xvi8ger4spp): each
    rank-``arch_rank`` update clamps the int32 accumulator instead of
    wrapping.  Lowered by the registry's ``gemm.saturating`` op-class on
    the torch backend (no kernel computes it, as no MXU form did)."""
    return facility.contract(
        _GEMM, x, y, acc=acc,
        plan=facility.Plan(ger=kind, saturating=True, backend="torch",
                           out_dtype=facility.ACC))


def mma_pm_dot(x, y, *, kind: Ger, xmask, ymask, pmask=None, acc=None,
               backend: str = "kernel"):
    """Deprecated: ``facility.contract("mk,kn->mn", x, y, masks=(xmask,
    ymask, pmask), plan=Plan(ger=kind, ...))``.

    Prefixed masked rank-k update (paper eq. 3) at matrix granularity,
    lowered by the ``gemm.masked`` op-class: the kernels apply the
    predicates while they stage each panel, and the operands are never
    pre-masked.  I4GER8 (which ``contract`` refuses) takes the IMMA
    kernel's column predicate on the kernel backend where only ``ymask``
    is set, else the ``ref.pm_ger`` oracle.
    """
    if precision.policy(kind).packed_int4:
        if backend == "kernel" and xmask is None and pmask is None:
            return _gemm.mma_gemm(x, y, acc, kind=kind,
                                  masks=(None, ymask, None))
        return _ref.pm_ger(x, y, kind, xmask, ymask, pmask, acc)
    lowering.deprecated_shim(
        "ops.mma_pm_dot", 'contract("mk,kn->mn", x, y, '
        "masks=(xmask, ymask, pmask), acc=acc, plan=Plan(ger=kind, ...))")
    return facility.contract(_GEMM, x, y, acc=acc,
                             masks=(xmask, ymask, pmask),
                             plan=_plan(kind, None, backend, None))


def mma_conv2d(image, kernels, *, backend: str = "kernel",
               bf: int | None = None):
    """Deprecated: ``facility.contract(facility.CONV2D, image, kernels,
    plan=Plan(ger=Ger.F32GER, backend=..., block=...))``.

    SCONV: VALID stride-1 2-D convolution (paper section V-B) of the
    registry's ``conv`` op-class; ``bf`` names K3's filter tile.
    """
    lowering.deprecated_shim(
        "ops.mma_conv2d", "contract(facility.CONV2D, image, kernels, "
        "plan=Plan(ger=Ger.F32GER, backend=..., block=...))")
    return facility.contract(
        facility.CONV2D, image, kernels,
        plan=facility.Plan(
            ger=Ger.F32GER, backend=backend,
            block=(8, bf, 128) if bf is not None else None,
            out_dtype=torch.float32))
