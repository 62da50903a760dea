"""Fused GEMM epilogues: post-processing applied inside the deprime store.

Port of ``repro.kernels.epilogue``.  Contract:

  * The epilogue is applied to the *accumulator-dtype* tile, after the
    alpha scale, before the out_dtype cast:
        store(cast(residual + act(bias + alpha * acc)))
  * ``apply`` is the single implementation used by the kernels' plain
    versions and by ``lowering.Accumulator.deprime``; the CUDA kernels
    (csrc/) compute the same expression per element in fp32.
  * bias broadcasts along rows: shape (N,).  residual has the output shape.
  * gelu/silu are float-only; integer accumulators admit bias/relu/residual.
"""

from __future__ import annotations

import dataclasses

import torch


def _gelu_exact(v):
    # Exact (erf) gelu, not the tanh approximation (the reference keeps the
    # erf form so fused and eager evaluations agree).
    return v * (0.5 * (1.0 + torch.erf(v * 0.7071067811865476)))


ACTIVATIONS = {
    "relu": lambda v: torch.maximum(v, torch.zeros_like(v)),
    "gelu": _gelu_exact,
    "silu": torch.nn.functional.silu,
}

# The activation codes the CUDA kernels take (csrc/epilogue.cuh).
ACT_CODES = {None: 0, "relu": 1, "silu": 2, "gelu": 3}


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Static description of the fused post-processing.

    The actual bias/residual operands travel separately; this object only
    records *which* terms are present.
    """

    bias: bool = False
    activation: str | None = None   # relu | gelu | silu
    residual: bool = False

    def __post_init__(self):
        if self.activation is not None and self.activation not in ACTIVATIONS:
            raise ValueError(
                f"unknown activation {self.activation!r}; "
                f"have {sorted(ACTIVATIONS)}")

    @property
    def is_identity(self) -> bool:
        return not (self.bias or self.activation or self.residual)

    @property
    def key(self) -> str:
        """Autotune cache-key fragment, e.g. 'bias+gelu+residual' or
        'none' (the reference's)."""
        parts = ([p for p, on in (("bias", self.bias),
                                  (self.activation, self.activation),
                                  ("residual", self.residual)) if on])
        return "+".join(parts) if parts else "none"

    def validate(self, acc_dtype, bias=None, residual=None) -> None:
        """Check operand presence and int-accumulator restrictions."""
        if self.bias != (bias is not None):
            raise ValueError(f"epilogue.bias={self.bias} but "
                             f"bias operand {'missing' if self.bias else 'given'}")
        if self.residual != (residual is not None):
            raise ValueError(f"epilogue.residual={self.residual} but "
                             f"residual operand "
                             f"{'missing' if self.residual else 'given'}")
        if (self.activation in ("gelu", "silu")
                and not acc_dtype.is_floating_point):
            raise ValueError(
                f"{self.activation} needs a float accumulator, got {acc_dtype}")


def apply(out: torch.Tensor, ep: Epilogue | None,
          bias: torch.Tensor | None = None,
          residual: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the epilogue terms to an accumulator-dtype tile or matrix."""
    if ep is None or ep.is_identity:
        return out
    if ep.bias:
        out = out + bias.to(out.dtype)
    if ep.activation:
        out = ACTIVATIONS[ep.activation](out)
    if ep.residual:
        out = out + residual.to(out.dtype)
    return out


def make(bias=None, activation: str | None = None, residual=None) -> Epilogue:
    """Build the static Epilogue matching the operands actually supplied."""
    return Epilogue(bias=bias is not None, activation=activation,
                    residual=residual is not None)
