"""Prefill and serve step functions (port of ``repro.train.steps``).

Only the serving steps are ported in this slice; ``make_train_step`` and
the optimizer come with the training slice (ROADMAP queue 1, A9).  The
reference jits these; PyTorch runs them eagerly.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M


def make_prefill_step(cfg):
    def prefill_step(model, batch):
        return M.prefill(model, batch, cfg)
    return prefill_step


def make_serve_step(cfg):
    """Greedy decode step: (model, cache, tokens) -> (next, logits, cache)."""
    def serve_step(model, cache, tokens):
        logits, cache = M.decode_step(model, cache, tokens, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return nxt.to(torch.int32), logits, cache
    return serve_step
