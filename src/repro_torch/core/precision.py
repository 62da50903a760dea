"""GerKind: the MMA facility's rank-k update families, on an NVIDIA H100.

Power ISA MMA defines one rank-k outer-product-accumulate instruction family
per input precision (Table I of the paper).  Each family fixes (a) the input
element type of the X and Y panels, (b) the accumulator element type, and
(c) the rank k of a single update.  This is the port of
``repro.core.precision`` with torch dtypes.

Where Hopper forces a family to adapt (see ``adapted``):

  * F32GER is true fp32: the GEMM kernel runs fp32 FMAs, never TF32, and
    every f32 parity claim runs with ``torch.backends.cuda.matmul.allow_tf32
    = False`` (PyTorch's default; chip_smoke.py sets it explicitly).
  * F64GER runs on the fp64 tensor cores (``csrc/gemm_dmma.cu``, DMMA
    m16n8k8 and m16n8k4).
  * I8GER4 runs on the int8 tensor cores (``csrc/gemm_imma.cu``, IMMA
    m16n8k32, signed X times unsigned Y as the instruction defines them).
  * I4GER8: Hopper's tensor cores do no int4 work, so the IMMA kernel
    unpacks the nibbles to int8 while it stages each panel.
  * I16GER2: there is no int16 MMA; the IMMA kernel splits each int16
    into a signed high and an unsigned low byte and sums four int8
    products, exact modulo 2^32.

Integer families accumulate in int32 and wrap modulo 2^32, as the
reference's int32 ``dot_general`` does.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Ger(enum.Enum):
    """MMA rank-k update instruction families (paper Table I)."""

    # Floating point families.
    F64GER = "xvf64ger"        # fp64 in, fp64 4x2 acc, rank-1
    F32GER = "xvf32ger"        # fp32 in, fp32 4x4 acc, rank-1
    BF16GER2 = "xvbf16ger2"    # bf16 in, fp32 acc, rank-2
    F16GER2 = "xvf16ger2"      # fp16 in, fp32 acc, rank-2
    # Integer families.
    I16GER2 = "xvi16ger2"      # int16 in, int32 acc, rank-2
    I8GER4 = "xvi8ger4"        # int8 x uint8 in, int32 acc, rank-4
    I4GER8 = "xvi4ger8"        # int4 in, int32 acc, rank-8
    # Beyond-paper kind: fp32 operands emulated by three bf16 products
    # (hi*hi + hi*lo + lo*hi), chained through the bf16 tensor-core path.
    F32GER_3XBF16 = "f32ger.3xbf16"


@dataclasses.dataclass(frozen=True)
class GerPolicy:
    """Resolved numeric policy for one Ger family."""

    ger: Ger
    x_dtype: torch.dtype
    y_dtype: torch.dtype
    acc_dtype: torch.dtype
    # Rank of the architected instruction (bookkeeping / oracle tests).
    arch_rank: int
    # True when the H100 lowering differs from a literal port.
    adapted: bool = False
    # int4 inputs arrive packed two-per-int8 along K.
    packed_int4: bool = False

    @property
    def in_bytes(self) -> int:
        return self.x_dtype.itemsize

    @property
    def is_integer(self) -> bool:
        return not self.acc_dtype.is_floating_point


_POLICIES = {
    Ger.F64GER: GerPolicy(Ger.F64GER, torch.float64, torch.float64,
                          torch.float64, arch_rank=1, adapted=True),
    Ger.F32GER: GerPolicy(Ger.F32GER, torch.float32, torch.float32,
                          torch.float32, arch_rank=1),
    Ger.BF16GER2: GerPolicy(Ger.BF16GER2, torch.bfloat16, torch.bfloat16,
                            torch.float32, arch_rank=2),
    Ger.F16GER2: GerPolicy(Ger.F16GER2, torch.float16, torch.float16,
                           torch.float32, arch_rank=2),
    Ger.I16GER2: GerPolicy(Ger.I16GER2, torch.int16, torch.int16,
                           torch.int32, arch_rank=2, adapted=True),
    Ger.I8GER4: GerPolicy(Ger.I8GER4, torch.int8, torch.uint8, torch.int32,
                          arch_rank=4),
    Ger.I4GER8: GerPolicy(Ger.I4GER8, torch.int8, torch.int8, torch.int32,
                          arch_rank=8, adapted=True, packed_int4=True),
    Ger.F32GER_3XBF16: GerPolicy(Ger.F32GER_3XBF16, torch.float32,
                                 torch.float32, torch.float32, arch_rank=1,
                                 adapted=True),
}


def policy(ger: Ger) -> GerPolicy:
    return _POLICIES[ger]


def default_ger_for(dtype: torch.dtype) -> Ger:
    """Pick the facility family a given activation dtype routes through."""
    return {
        torch.bfloat16: Ger.BF16GER2,
        torch.float16: Ger.F16GER2,
        torch.float32: Ger.F32GER,
        torch.float64: Ger.F64GER,
        torch.int8: Ger.I8GER4,
    }[dtype]
