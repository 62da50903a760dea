"""Eager torch oracles for the MMA kernels (port of ``repro.kernels.ref``).

These implement the architected semantics of the paper's instructions
(sections II-B, II-C) at matrix granularity, with no tiling — the ground
truth the kernels are tested against.
"""

from __future__ import annotations

import torch

from repro_torch.core import precision


# |sum| below 2**53: every partial sum of a float64 product of integers
# is then an exact integer.
_F64_EXACT = 2 ** 53


def unpack_int4(x_packed: torch.Tensor) -> torch.Tensor:
    """Unpack two's-complement nibbles (low nibble first) along the last
    axis: (..., K/2) int8 -> (..., K) int8."""
    lo = (x_packed << 4) >> 4                  # arithmetic: sign-extends
    hi = x_packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*x_packed.shape[:-1], -1)


def _max_abs(t: torch.Tensor) -> int:
    if t.numel() == 0:
        return 0
    return max(abs(int(t.max())), abs(int(t.min())))


def int_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """X @ Y of integer operands as the reference's int32 ``dot_general``
    computes it: exact products, the sum wrapped modulo 2**32.  On the CPU
    in int64; CUDA has no integer matmul, so there the product runs in
    float64, exact while K * max|x| * max|y| < 2**53 (asserted), and the
    int64 result is wrapped to int32."""
    if x.device.type == "cpu":
        return torch.matmul(x.to(torch.int64), y.to(torch.int64)).to(
            torch.int32)
    big = x.shape[-1] * _max_abs(x) * _max_abs(y)
    if big >= _F64_EXACT:
        raise ValueError(f"float64 integer product not exact: K * max|x| * "
                         f"max|y| = {big} >= 2**53")
    return torch.matmul(x.to(torch.float64), y.to(torch.float64)).to(
        torch.int64).to(torch.int32)


def product(x: torch.Tensor, y: torch.Tensor,
            pol: precision.GerPolicy) -> torch.Tensor:
    """X @ Y of one family in its accumulator dtype, (batched) 2-D: int4
    operands unpacked along K (x's last axis, y's second to last), integer
    products by :func:`int_matmul`, float ones in the accumulator dtype."""
    if pol.packed_int4:
        x = unpack_int4(x)
        y = unpack_int4(y.transpose(-1, -2)).transpose(-1, -2)
    if pol.is_integer:
        return int_matmul(x, y)
    return torch.matmul(x.to(pol.acc_dtype), y.to(pol.acc_dtype))


def ger(x: torch.Tensor, y: torch.Tensor, kind: precision.Ger,
        acc: torch.Tensor | None = None,
        neg_product: bool = False, neg_acc: bool = False) -> torch.Tensor:
    """Rank-k update oracle:  A <- [-] X @ Y [+/- A]   (paper eq. 1 and 2).

    x: (M, K), y: (K, N) in the family's input dtype (int4: packed along
    K, x as (M, K/2) and y as (K/2, N)).  Returns the accumulator in the
    family's accumulator dtype.  Float products are formed in the
    accumulator dtype (exact for bf16/f16 inputs into fp32); integer ones
    by :func:`int_matmul`, wrapping modulo 2**32.
    """
    pol = precision.policy(kind)
    prod = product(x, y, pol)
    if neg_product:
        prod = -prod
    if acc is None:
        return prod
    acc = acc.to(pol.acc_dtype)
    return prod + (-acc if neg_acc else acc)


def pm_ger(x: torch.Tensor, y: torch.Tensor, kind: precision.Ger,
           xmask: torch.Tensor, ymask: torch.Tensor,
           pmask: torch.Tensor | None = None,
           acc: torch.Tensor | None = None) -> torch.Tensor:
    """Prefixed masked update oracle (paper eq. 3).

    xmask: (M,) bool -- enabled rows of X; ymask: (N,) bool -- enabled
    columns of Y^T; pmask: (K,) bool -- enabled partial products along the
    rank.  Disabled lanes are multiplied out by zeros, as the reference's
    oracle does (so a NaN in a disabled lane stays NaN here; the kernels
    and the other lowerings select instead).  I4GER8 unpacks its nibbles,
    then takes I8GER4's product.
    """
    pol = precision.policy(kind)
    if pol.packed_int4:
        x = unpack_int4(x)
        y = unpack_int4(y.transpose(0, 1)).transpose(0, 1)
        kind = precision.Ger.I8GER4
    xm = xmask.to(x.dtype)[:, None]
    ym = ymask.to(y.dtype)[None, :]
    if pmask is not None:
        xm = xm * pmask.to(x.dtype)[None, :]
    prod = ger((x * xm).to(x.dtype), (y * ym).to(y.dtype), kind)
    prod = prod.to(pol.acc_dtype)
    return prod if acc is None else prod + acc.to(pol.acc_dtype)


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
