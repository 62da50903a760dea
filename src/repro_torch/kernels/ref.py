"""Eager torch oracles for the MMA kernels (port of ``repro.kernels.ref``).

These implement the architected semantics of the paper's instructions
(sections II-B, II-C) at matrix granularity, with no tiling — the ground
truth the kernels are tested against.  ``pm_ger`` and ``unpack_int4``
come with their slices (ROADMAP queue 2, K1b/K1f).
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


def conv2d(image: torch.Tensor, kernels: torch.Tensor,
           stride: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """SCONV oracle (paper section V-B): VALID 2-D convolution.

    image: (N, H, W, C), kernels: (KH, KW, C, F).  No padding, stride
    (sh, sw), computed by explicitly materializing the Abar patch matrix
    (eq. 8): (N*OH*OW, KH*KW*C) @ (KH*KW*C, F) with an fp32 result.
    """
    n, h, w, c = image.shape
    kh, kw, _, f = kernels.shape
    sh, sw = stride
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    patches = [image[:, i:i + (oh - 1) * sh + 1:sh,
                     j:j + (ow - 1) * sw + 1:sw, :]
               for i in range(kh) for j in range(kw)]
    abar = torch.cat(patches, dim=-1).reshape(n * oh * ow, kh * kw * c)
    hbar = kernels.reshape(kh * kw * c, f)
    return torch.matmul(abar.float(), hbar.float()).reshape(n, oh, ow, f)


def depthwise_conv(image: torch.Tensor, taps: torch.Tensor,
                   stride: tuple[int, int] = (1, 1),
                   acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Depthwise (groups == C) VALID conv oracle: eager shift-and-sum.

    image: (N, H, W, C), taps: (KH, KW, C) -- channel c of the output sees
    only channel c of the input, so the oracle is the literal sum of
    KH*KW elementwise-scaled shifts, in ``acc_dtype``.
    """
    n, h, w, c = image.shape
    kh, kw, _ = taps.shape
    sh, sw = stride
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    out = torch.zeros((n, oh, ow, c), dtype=acc_dtype, device=image.device)
    for i in range(kh):
        for j in range(kw):
            sl = image[:, i:i + (oh - 1) * sh + 1:sh,
                       j:j + (ow - 1) * sw + 1:sw, :]
            out = out + sl.to(acc_dtype) * taps[i, j].to(acc_dtype)
    return out
