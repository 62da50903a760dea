"""Gradients of the kernel wrappers whose TPU kernels had none.

The reference's Pallas kernels cannot be differentiated (it trains on
XLA); no TPU backward kernel exists to port.  The attention and conv
wrappers' ``torch.autograd.Function``s therefore run their kernel forward
and, in the backward, differentiate a recomputation through the eager
``torch`` lowering of ``core/lowering.py``: a static route, not a
fallback.  A fused residual is added after the activation, so its
gradient is dOut itself and the recomputation leaves it out.
"""

from __future__ import annotations

import dataclasses

import torch


def wants_grad(*tensors) -> bool:
    """True where autograd is recording and an operand requires a
    gradient: the wrappers then run as their Function."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def without_residual(ep):
    """The epilogue ``ep`` with its residual term dropped (None stays)."""
    return dataclasses.replace(ep, residual=False) if ep is not None else None


def recompute(fn, tensors, needs, dout):
    """Gradients of ``fn(*tensors)`` with respect to each tensor whose
    ``needs`` flag is set (None elsewhere), by autograd on a fresh
    recomputation with cotangent ``dout``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) if t is not None
                  else None for t, n in zip(tensors, needs)]
        want = [t for t in leaves if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(fn(*leaves), want, dout)
                   if want else ())
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in leaves)
