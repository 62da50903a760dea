"""The MMA facility: ONE architected builtin in front of all matrix math
(port of ``repro.core.facility``).

Every matrix contraction of the port's models — attention projections,
MLP GEMMs, attention itself, the SSD products, mamba2's causal conv,
logits — routes through :func:`contract`:

    contract(spec, x, y, plan=Plan(...))

``spec`` is an einsum-like contraction spec (``"mk,kn->mn"``,
``"...k,kn->...n"``, ...) and :class:`Plan` bundles the static policy: ger
family, epilogue, accumulate forms, out dtype, backend and tile override.
Lowering is owned by the registry in ``repro_torch.core.lowering``:
``kernel`` (the hand-written Hopper kernels), ``torch`` (eager ops) and
``ref`` (the oracles).

The facility runs on the card unless the caller asks for the CPU:
``FacilityConfig()`` resolves its device to ``cuda`` and raises when CUDA is
absent; ``FacilityConfig(device="cpu")`` is the explicit CPU mode in which
each kernel wrapper runs its plain version.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools

import torch

from repro_torch.core import lowering, precision

Ger = precision.Ger
Plan = lowering.Plan
ACC = lowering.ACC
Epilogue = lowering.Epilogue
Dequant = lowering.Dequant
attend_chunk = lowering.attend_chunk
repeat_kv = lowering.repeat_kv

# The workhorse spec: contract the last axis of x with the first of w.
DOT = "...k,kn->...n"

# Convolutions (NHWC image, HWIO filters; stride and valid/same/causal
# padding ride in the Plan): dense 2-D, dense 1-D over the L axis, and
# depthwise 1-D with per-channel taps (L, C).
CONV2D = lowering.CONV2D
CONV1D = lowering.CONV1D
CONV1D_DEPTHWISE = lowering.CONV1D_DEPTHWISE

# Fused attention: q (B, Sq, H, D); k, v (B, Sk, KVH, D); causal/window/
# q_offset ride in the Plan, the (B, Sk) valid-slot predicate as
# ``masks=(valid,)``.
ATTN = lowering.ATTN

BACKENDS = lowering.BACKENDS


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none
    raises: the port never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "versions on the CPU explicitly")
    return dev


@dataclasses.dataclass(frozen=True)
class FacilityConfig:
    """Numeric policy and placement for a model's matrix math."""

    ger: Ger = Ger.BF16GER2               # activation-side GEMM family
    out_dtype: torch.dtype = torch.bfloat16   # activation dtype between ops
    backend: str = "kernel"               # kernel | torch | ref
    device: object = None                 # None -> "cuda" (raises if absent)
    # Guarded dispatch (core/lowering._guarded_dispatch): contract outputs
    # pass a NaN/Inf detector and lowering failures demote down the
    # kernel -> torch -> ref ladder, quarantined per (op-class, ger, spec,
    # shapes).  Off by default: the unguarded dispatch is bit for bit the
    # same and pays no detector sync.
    guards: bool = False
    # ABFT checksum verification (core/abft.py) inside guarded dispatch:
    # finite but wrong outputs become a guard outcome too (retry once, then
    # demote).  Needs guards=True; a separate flag because the attn/conv
    # checks augment operands with a checksum column, which moves rounding
    # (guards alone stay bit for bit).
    abft: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"have {BACKENDS}")
        object.__setattr__(self, "device", resolve_device(self.device))


_CONFIG: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_facility", default=None)


@functools.lru_cache(maxsize=1)
def _default_config() -> FacilityConfig:
    return FacilityConfig()


def current() -> FacilityConfig:
    """The configured facility, else the default (on the card)."""
    cfg = _CONFIG.get()
    return cfg if cfg is not None else _default_config()


@contextlib.contextmanager
def configure(cfg: FacilityConfig):
    token = _CONFIG.set(cfg)
    try:
        yield cfg
    finally:
        _CONFIG.reset(token)


def contract(spec: str, x: torch.Tensor, y: torch.Tensor,
             z: torch.Tensor | None = None, *,
             plan: Plan | None = None,
             acc: torch.Tensor | None = None,
             bias: torch.Tensor | None = None,
             residual: torch.Tensor | None = None,
             dequant: Dequant | None = None,
             masks: tuple | None = None) -> torch.Tensor:
    """The facility's single architected builtin.

    ``spec`` names the contraction; ``plan`` selects ger family,
    accumulate form, epilogue, out dtype, backend and tile — unset fields
    resolve against the ambient :class:`FacilityConfig`.  ``acc`` seeds
    the accumulator (the pp/np/pn/nn forms, scaled by ``plan.beta``);
    ``bias``/``residual`` are the fused-epilogue operands.  ``dequant`` is
    the quant path's deprime rescale (:class:`Dequant`; not with attn,
    conv, complex operands, masks, a fused epilogue or saturating forms).
    Complex operands run the ``complex`` op-class, ``plan.saturating`` the
    clamped integer forms.  ``z`` is the value operand of :data:`ATTN`,
    where ``masks`` is the 1-tuple ``(valid,)``: the (Sk,) or (B, Sk)
    filled-KV-slot predicate.  For a gemm spec in the natural
    ``(batch..., M, K) x (batch..., K, N)`` layout, ``masks`` is the pm*
    3-tuple ``(xmask (M,), ymask (N,), pmask (K,))`` of bool tensors
    (paper eq. 3; any entry may be None, and each is shared across the
    batch axes): disabled rows of X, columns of Y and ranks contribute
    exact zeros (the ``gemm.masked`` op-class; not with dequant or
    I4GER8, which ``kernels.ops.mma_pm_dot`` sends to ``ref.pm_ger``).
    """
    return lowering.execute(spec, x, y, z, cfg=current(), plan=plan,
                            acc=acc, bias=bias, residual=residual,
                            dequant=dequant, masks=masks)
