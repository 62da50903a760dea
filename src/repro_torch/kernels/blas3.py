"""Other computations built from rank-k updates (port of
``repro.kernels.blas3``; paper section III: "the instructions ... can be
used as building blocks of other computations, such as convolution,
triangular solve and discrete Fourier transform").  Convolution is the
registry's ``conv`` op-class; this module keeps the other two as thin
plans over ``facility.contract``:

* ``trsm``: blocked lower-triangular solve.  The panel update
  ``B_i <- B_i - L_ij @ X_j`` is exactly the *np* accumulate form
  ``A <- -XY + A`` (paper eq. 2), chained across block columns.
* ``complex_gemm`` / ``dft``: complex matmul through the registry's
  ``complex`` op-class -- four real rank-k updates using the pp/np forms
  (re <- re@re [-] im@im, im <- re@im [+] im@re), lowered by whichever
  backend the plan selects (by default the kernel: F32GER for complex64,
  F64GER on the DMMA kernel for complex128, BF16GER2 for bf16 signals);
  the DFT applies the twiddle matrix through it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import facility, packing
from repro_torch.core.precision import Ger


def _ger(x, y, kind, acc=None, neg_product=False):
    """Accumulate-form ger through the facility (the registry's ACC
    lifecycle carries the pp/np forms), so trsm's panel updates share its
    validation and accumulate-form semantics.  The torch backend is
    pinned, as the reference pins xla: these panels are small and
    irregular, so they are not kernel-lowered."""
    return facility.contract(
        "mk,kn->mn", x, y, acc=acc,
        plan=facility.Plan(ger=kind, neg_product=neg_product,
                           backend="torch", out_dtype=facility.ACC))


def trsm(l: torch.Tensor, b: torch.Tensor, *, block: int = 64,
         unit_diagonal: bool = False) -> torch.Tensor:
    """Solve L X = B for X; L (N, N) lower-triangular, B (N, M).

    Blocked forward substitution: the trailing updates are MMA 'np'
    accumulate-form gers (F32GER); only the (block x block) diagonal
    solves are scalar-substitution code.
    """
    n, m = b.shape
    nb = -(-n // block)
    x = torch.zeros_like(b)
    for i in range(nb):
        lo, hi = i * block, min((i + 1) * block, n)
        rhs = b[lo:hi]
        if i > 0:
            # rhs <- rhs - L[i, :i] @ X[:i]   (xvf32gernp chaining)
            rhs = _ger(l[lo:hi, :lo], x[:lo], Ger.F32GER, acc=rhs,
                       neg_product=True)
        xi = torch.linalg.solve_triangular(
            l[lo:hi, lo:hi].to(rhs.dtype), rhs, upper=False,
            unitriangular=unit_diagonal)
        x[lo:hi] = xi.to(x.dtype)
    return x


def _complex_contract(spec, ar, ai, br, bi, kind: Ger, backend):
    """One complex-op-class contraction: pack (re, im) components, run the
    four-real-ger plan, unpack.  Shared by the 2-D and batched DFT entry
    points so the dtype selection and Plan stay in one place."""
    fdt = torch.float64 if kind == Ger.F64GER else torch.float32
    a = torch.complex(ar.to(fdt), ai.to(fdt))
    b = torch.complex(br.to(fdt), bi.to(fdt))
    out = facility.contract(
        spec, a, b,
        plan=facility.Plan(ger=kind, backend=backend,
                           out_dtype=facility.ACC))
    return out.real, out.imag


def complex_gemm(ar, ai, br, bi, kind: Ger = Ger.F32GER,
                 backend: str | None = None):
    """(ar + i ai) @ (br + i bi) via the registry's ``complex`` op-class
    (four real accumulate-form gers: four GEMM launches on the kernel
    backend).  Returns (re, im) in the family's accumulator dtype."""
    return _complex_contract("mk,kn->mn", ar, ai, br, bi, kind, backend)


_KIND_FOR_DTYPE = {
    torch.float64: Ger.F64GER,
    torch.float32: Ger.F32GER,
    torch.bfloat16: Ger.BF16GER2,
    torch.float16: Ger.F16GER2,
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _twiddle_block(n: int, dtype: torch.dtype) -> tuple:
    """The configuration the (N, N, N) twiddle GEMM would dispatch at --
    the packed store's freshness key."""
    kind = _KIND_FOR_DTYPE.get(dtype, Ger.F32GER)
    return packing.plan_gemm_block(kind, n, n, n)


def _twiddle(n: int, dtype: torch.dtype = torch.float32):
    """Host-side twiddle factors (cos, sin) from the facility's packed
    store, keyed by (n, dtype, block config).
    ``packing.STORE.invalidate(("dft.twiddle",))`` drops every cached
    matrix.

    Built in float64 on the host with numpy and rounded ONCE to the target
    dtype -- never through an f32 intermediate, which perturbs the bf16
    entries at large k^2.  numpy has no bf16, so the rounding is torch's
    float64 -> dtype cast on the host; the result is a CPU tensor, and
    nothing is kept on the card between calls.
    """
    def build():
        k = np.arange(n)
        ang = -2.0 * np.pi * np.outer(k, k) / n
        return (torch.from_numpy(np.cos(ang)).to(dtype),
                torch.from_numpy(np.sin(ang)).to(dtype))

    key = ("dft.twiddle", n, _dtype_name(dtype), _twiddle_block(n, dtype))
    return packing.STORE.get_or_build(key, build)


def dft(x_re: torch.Tensor, x_im: torch.Tensor | None = None,
        kind: Ger | None = None, backend: str | None = None):
    """Dense DFT via the complex op-class: (N, M) signals transform along
    axis 0; a batched stack (B, N, M) transforms along axis -2.

    (O(N^2) matrix form -- the matrix-multiply formulation of small and
    batched DFTs that the paper refers to.)  Twiddles are built in the
    *input's* dtype, so a bf16 caller folds bf16-rounded twiddles.

    The batched plan shares one (N, N) twiddle matrix across the stack:
    the spec ``"nk,bkm->nbm"`` folds the batch axis into the GEMM's free
    columns, so the whole stack is ONE launch per accumulate-form ger
    (four a call), with no per-signal loop and no twiddle duplication.
    """
    if x_re.ndim not in (2, 3):
        raise ValueError(f"dft wants (N, M) or (B, N, M) signals, "
                         f"got {tuple(x_re.shape)}")
    n = x_re.shape[-2]
    wr, wi = _twiddle(n, x_re.dtype)
    wr, wi = wr.to(x_re.device), wi.to(x_re.device)
    if x_im is None:
        x_im = torch.zeros_like(x_re)
    kind = kind or _KIND_FOR_DTYPE.get(x_re.dtype, Ger.F32GER)
    if x_re.ndim == 2:
        return complex_gemm(wr, wi, x_re, x_im, kind=kind, backend=backend)
    re, im = _complex_contract("nk,bkm->nbm", wr, wi, x_re, x_im, kind,
                               backend)
    return re.transpose(0, 1), im.transpose(0, 1)      # -> (B, N, M)
