"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

Parameters, gradients and the moments are dicts of tensors keyed by
parameter name (``dict(model.named_parameters())``), in one order.  The
step is a device tensor, so a train step reads no number back to the
host.  Unlike the reference, which returns new arrays, ``apply_updates``
writes the parameters and both moments in place: the training state of a
7B-class model is tens of GB, and a second copy would not fit the card.

Sharded leaves (``DTensor``s on a mesh, ``parallel.api``) are updated on
their local shards, and the global norm sums each rank's local squares
(divided by how many ranks hold each element) over the world.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.parallel import api as par


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # decay only matrices (>=2D); norms/biases/embeddings excluded by rank
    decay_min_ndim: int = 2


def init_state(params: dict[str, torch.Tensor]) -> dict:
    """``{"step": 0, "m": zeros, "v": zeros}``, each moment in its
    parameter's dtype and on its device."""
    device = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": {k: par.zeros_like(p) for k, p in params.items()},
            "v": {k: par.zeros_like(p) for k, p in params.items()}}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in fp32."""
    total = None
    sharded = False
    for g in tree.values():
        sq = torch.sum(torch.square(par.local(g).to(torch.float32)))
        if par.is_dtensor(g):
            sharded = True
            sq = sq / par.replication(g)
        total = sq if total is None else total + sq
    if sharded:
        total = par.all_reduce_world(total)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor], state: dict,
                  cfg: AdamWConfig):
    """One AdamW step, in place.  Returns (params, state, metrics) with
    metrics ``{"grad_norm", "lr"}`` as fp32 device tensors."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = (cfg.lr(step) if callable(cfg.lr)
          else torch.full((), cfg.lr, dtype=torch.float32,
                          device=step.device))
    t = step.to(torch.float32)
    c1 = 1 - torch.pow(cfg.b1, t)
    c2 = 1 - torch.pow(cfg.b2, t)
    for name, p in params.items():
        g = par.local(grads[name]).to(torch.float32) * scale
        m, v = par.local(state["m"][name]), par.local(state["v"][name])
        p = par.local(p)
        m1 = cfg.b1 * m + (1 - cfg.b1) * g
        v1 = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m1 / c1) / (torch.sqrt(v1 / c2) + cfg.eps)
        pf = p.to(torch.float32)
        if p.ndim >= cfg.decay_min_ndim:
            delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
        m.copy_(m1)
        v.copy_(v1)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
