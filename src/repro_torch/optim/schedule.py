"""LR schedules (port of ``repro.optim.schedule``): each takes the step as
a tensor and returns the fp32 learning rate as a tensor on its device, so
a train step reads its rate without a host sync."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak_lr`` at ``total_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clip((step - warmup_steps)
                          / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(peak_lr: float):
    return lambda step: torch.full((), peak_lr, dtype=torch.float32,
                                   device=step.device)
