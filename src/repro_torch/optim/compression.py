"""Gradient compression (port of ``repro.optim.compression``): a bf16
payload with an fp32 error-feedback residual.  The residual keeps the
long-run update unbiased; on one card there is no all-reduce to shrink,
so the port applies it for the same arithmetic as the reference's."""

from __future__ import annotations

import torch


def init_residual(params: dict[str, torch.Tensor]) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@torch.no_grad()
def compress(grads: dict[str, torch.Tensor], residual: dict):
    """Returns (bf16 grads-to-reduce, new residual)."""
    qs, rs = {}, {}
    for k, g in grads.items():
        full = g.to(torch.float32) + residual[k]
        q = full.to(torch.bfloat16)
        qs[k], rs[k] = q, full - q.to(torch.float32)
    return qs, rs


def decompress(qgrads: dict) -> dict:
    return {k: q.to(torch.float32) for k, q in qgrads.items()}
