"""int8 weight quantization for serving -- the xvi8ger4 exploitation path
(port of ``repro.core.quant``).

The paper's DL story (section I) is mixed-precision inference: int8 inputs
with int32 accumulation.  Here: symmetric per-output-channel weight
quantization; activations quantized per row at run time; the int32 ger
result rescaled to floating point.  Matches the signed x unsigned
asymmetry of xvi8ger4 by biasing activations into uint8.  On the card the
ger runs the IMMA kernel (``csrc/gemm_imma.cu``).

Prepacked quantized weights: :func:`qdot` takes a ``PackedOperand`` of
X-side int8 panels (``prepack_params_for_serving(..., quantize=True)``,
re-exported here from ``core/packing.py`` as in the reference), whose
scales and Dequant column sums ride the descriptor and whose panels the
IMMA kernel streams with no per-call copy of W^T.
"""

from __future__ import annotations

import torch

from repro_torch.core import facility, lowering, packing
from repro_torch.core.precision import Ger


def quantize_weight(w: torch.Tensor):
    """fp -> (int8 weight, per-column fp32 scale).  w: (K, N)."""
    amax = w.abs().amax(dim=0, keepdim=True)                     # (1, N)
    scale = torch.where(amax == 0, 1.0, amax / 127.0).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_act_u8(x: torch.Tensor):
    """fp -> (uint8 activation, per-row scale, per-row zero point).

    x: (M, K); uint8 with a zero point (the paper's unsigned Y operand)."""
    xmin = x.amin(dim=1, keepdim=True)
    xmax = x.amax(dim=1, keepdim=True)
    scale = torch.where(xmax > xmin, (xmax - xmin) / 255.0, 1.0)
    zp = torch.round(-xmin / scale)
    q = torch.clamp(torch.round(x / scale) + zp, 0, 255).to(torch.uint8)
    return q, scale.to(torch.float32), zp.to(torch.float32)


def qdot(x: torch.Tensor, wq: torch.Tensor,
         wscale: torch.Tensor | None = None,
         out_dtype: torch.dtype = torch.float32, *,
         backend: str | None = None) -> torch.Tensor:
    """Quantized matmul: fp activations x int8 weights -> fp.

    x: (M, K) fp; wq: (K, N) int8.  Activations are quantized per row to
    uint8 (zero-point form), then the whole thing is ONE ``I8GER4`` plan
    through ``facility.contract``: the spec ``"kn,mk->mn"`` puts the
    signed weights on the X (int8) operand and the unsigned activations on
    the Y (uint8) operand -- the paper's signed x unsigned asymmetry -- and
    the zero-point/scale correction rides the deprime stage as a
    :class:`~repro_torch.core.lowering.Dequant` rescale of the int32
    accumulator (x ~ (q - zp) * xs  ->  x @ w = xs * (q @ w) - xs * zp *
    colsum(w), then per-column weight scales).

    The spec permutes the output, so the product the kernel sees is W^T
    (N, K) times Xq^T (K, M): with a natural ``wq`` the gemm lowering
    copies W^T on every call, and it makes the K-major activations N-major
    (chip_smoke.py times both copies).

    ``wq`` may also be a prepacked :class:`~repro_torch.core.packing.
    PackedOperand` of X-side int8 panels: its per-column scales (unless
    ``wscale`` is given) and Dequant column sums ride the descriptor, the
    contract streams the panels into the IMMA kernel with no W^T copy, and
    the int32 accumulator is the natural qdot's bit for bit.
    """
    if packing.is_packed(wq):
        if wscale is None:
            wscale = wq.scale
        wsum = wq.col_sum
        if wscale is None or wsum is None:
            raise ValueError("packed qdot weight is missing its scale/"
                             "col_sum metadata; pack with "
                             "prepack_params_for_serving(quantize=True)")
    elif not isinstance(wq, torch.Tensor):
        raise TypeError(f"qdot takes an int8 tensor or a PackedOperand, "
                        f"not a {type(wq).__name__}")
    else:
        if wscale is None:
            raise ValueError("natural-layout qdot needs explicit wscale")
        wsum = wq.to(torch.int32).sum(dim=0).to(torch.float32)   # (N,)
    xq, xs, xzp = quantize_act_u8(x.to(torch.float32))
    dq = lowering.Dequant(row_scale=xs, row_zp=xzp, col_sum=wsum,
                          col_scale=wscale)
    return facility.contract(
        "kn,mk->mn", wq, xq, dequant=dq,
        plan=lowering.Plan(ger=Ger.I8GER4, out_dtype=out_dtype,
                           backend=backend))


def quantize_params_for_serving(params, min_size: int = 1 << 16):
    """Quantize every large 2-D fp32 weight of a (nested) dict of the
    port's parameters; returns (the same tree with ``{"q", "scale"}``
    leaves replacing the quantized ones, bytes_saved)."""
    saved = 0

    def visit(p):
        nonlocal saved
        if isinstance(p, dict):
            return {k: visit(v) for k, v in p.items()}
        if (isinstance(p, torch.Tensor) and p.ndim == 2
                and p.dtype == torch.float32 and p.numel() >= min_size):
            q, s = quantize_weight(p)
            saved += p.numel() * 3          # 4 B -> 1 B
            return {"q": q, "scale": s}
        return p

    return visit(params), saved


# The generalization of the pass above (dense weights, MoE expert banks and
# conv filter stacks in kernel-native packed layouts, optionally int8 X-side
# tiles for the I8GER4 path) lives in core/packing.py with the layouts;
# re-exported here, where the reference's serving callers find it.
prepack_params_for_serving = packing.prepack_params_for_serving
