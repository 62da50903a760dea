"""Eager torch oracles for the MMA kernels (port of ``repro.kernels.ref``).

These implement the architected semantics of the paper's instructions
(sections II-B, II-C) at matrix granularity, with no tiling — the ground
truth the kernels are tested against.  ``conv2d``, ``depthwise_conv``,
``pm_ger`` and ``unpack_int4`` come with their slices (ROADMAP queue 1,
B2/B3 and C).
"""

from __future__ import annotations

import torch

from repro_torch.core import precision


def ger(x: torch.Tensor, y: torch.Tensor, kind: precision.Ger,
        acc: torch.Tensor | None = None,
        neg_product: bool = False, neg_acc: bool = False) -> torch.Tensor:
    """Rank-k update oracle:  A <- [-] X @ Y [+/- A]   (paper eq. 1 and 2).

    x: (M, K), y: (K, N) in the family's input dtype.  Returns the
    accumulator in the family's accumulator dtype.  Products are formed
    in the accumulator dtype: exact for bf16/f16 inputs into fp32.
    """
    pol = precision.policy(kind)
    if pol.is_integer or pol.packed_int4:
        raise NotImplementedError(
            f"{kind.value}: the integer families are lowered with their "
            f"slices (ROADMAP queue 2, K1c/K1f)")
    prod = torch.matmul(x.to(pol.acc_dtype), y.to(pol.acc_dtype))
    if neg_product:
        prod = -prod
    if acc is None:
        return prod
    acc = acc.to(pol.acc_dtype)
    return prod + (-acc if neg_acc else acc)


def gemm(x: torch.Tensor, y: torch.Tensor, kind: precision.Ger,
         c: torch.Tensor | None = None,
         alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """Full GEMM oracle: C <- alpha * X @ Y + beta * C (paper eq. 4)."""
    out = ger(x, y, kind)
    out = alpha * out if alpha != 1.0 else out
    if c is not None and beta != 0.0:
        out = out + beta * c.to(out.dtype)
    return out
