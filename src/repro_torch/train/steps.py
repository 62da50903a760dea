"""Train, prefill and serve step functions (port of ``repro.train.steps``).

``make_train_step`` returns a (state, batch) -> (state, metrics) function:
microbatched gradient accumulation (a Python loop), optional bf16
error-feedback gradient compression, global-norm clipping and AdamW.  The
reference jits these; PyTorch runs them eagerly.

The train state is ``{"params": model, "opt": {"step", "m", "v"[,
"master"]}[, "residual"]}``: the model is the ``nn.Module`` whose float
parameters require gradients, the optimizer's trees are dicts of tensors
keyed by parameter name.  A step updates the state in place (the
optimizer writes the parameters and moments; see ``optim.adamw``) and
returns it.  ``train_state_axes`` (the sharding axes of this tree) comes
with the mesh (ROADMAP queue 1, E1).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.models import model as M
from repro_torch.optim import adamw, compression


def train_state_from(model: M.Model, opt_cfg: adamw.AdamWConfig, *,
                     compress: bool = False,
                     bf16_params: bool = False) -> dict:
    """The train state around ``model``, whose float parameters are made
    trainable here (``init_params`` and ``models.convert`` build frozen
    ones, for serving).  ``bf16_params``: the model's >= 2-D fp32 weights
    become bf16 compute copies, and the fp32 originals stay as the
    optimizer's ``master`` (the moments are fp32 too)."""
    for p in model.parameters():
        if p.dtype.is_floating_point:
            p.requires_grad_(True)
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = {"params": model, "opt": adamw.init_state(params)}
    if bf16_params:
        state["opt"]["master"] = params
        state["params"] = _bf16_view(model)
    if compress:
        state["residual"] = compression.init_residual(params)
    return state


def init_train_state(cfg, seed: int, opt_cfg: adamw.AdamWConfig, *,
                     compress: bool = False, bf16_params: bool = False,
                     device=None) -> dict:
    """Random fp32 weights from ``seed`` on ``device`` (default: the
    card), in a train state (:func:`train_state_from`)."""
    return train_state_from(M.init_params(cfg, seed=seed, device=device),
                            opt_cfg, compress=compress,
                            bf16_params=bf16_params)


def _bf16_view(model: M.Model) -> M.Model:
    """A copy of ``model`` whose >= 2-D fp32 parameters are bf16 leaves of
    their own (requiring a gradient as the originals do); every other
    parameter is the original object, shared.  The bf16 compute view of
    the mixed-precision recipe (bf16 compute, fp32 master weights)."""
    memo = {}
    for p in model.parameters():
        if p.dtype == torch.float32 and p.ndim >= 2:
            memo[id(p)] = nn.Parameter(p.detach().to(torch.bfloat16),
                                       requires_grad=p.requires_grad)
        else:
            memo[id(p)] = p
    return copy.deepcopy(model, memo)


def split_microbatches(batch: dict, n: int) -> list[dict]:
    """The reference's microbatch split: microbatch i holds rows
    [i * B/n, (i + 1) * B/n) of every array's leading batch axis, and of
    the batch axis (axis 1) of the (3, B, S) M-RoPE ``positions``."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        axis = 1 if k == "positions" else 0
        b = x.shape[axis]
        if b % n:
            raise ValueError(f"batch {b} of {k!r} does not split into "
                             f"{n} microbatches")
        for i, part in enumerate(torch.split(x, b // n, dim=axis)):
            out[i][k] = part
    return out


def loss_and_grads(cfg, model: M.Model, batch: dict, *,
                   bf16_weights: bool = False):
    """(loss, {"nll", "aux"}, grads) of ``models.model.loss_fn`` at
    ``model``'s parameters, the grads a dict by parameter name in each
    parameter's dtype (an unused parameter gets zeros, as JAX gives).
    ``bf16_weights``: the loss runs on the bf16 view of the weights, and
    each bf16 gradient comes back to its fp32 weight as the cast's
    gradient does."""
    view = _bf16_view(model) if bf16_weights else model
    names = [k for k, p in view.named_parameters() if p.requires_grad]
    leaves = [p for p in view.parameters() if p.requires_grad]
    loss, metrics = M.loss_fn(view, batch, cfg)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    dtypes = {k: p.dtype for k, p in model.named_parameters()}
    grads = {k: (torch.zeros_like(p) if g is None else g).to(dtypes[k])
             for k, p, g in zip(names, leaves, got)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    grad_accum: int = 1, compress: bool = False,
                    bf16_weights: bool = False, bf16_params: bool = False):
    """(state, batch) -> (state, metrics ``{"loss", "nll", "aux",
    "grad_norm", "lr"}``, fp32 device tensors)."""
    def train_step(state, batch):
        model = state["params"]
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(
                cfg, model, batch, bf16_weights=bf16_weights)
        else:
            grads, losses, mets = None, [], []
            for mb in split_microbatches(batch, grad_accum):
                l, met, g = loss_and_grads(cfg, model, mb,
                                           bf16_weights=bf16_weights)
                g = {k: v.to(torch.float32) for k, v in g.items()}
                grads = g if grads is None else {
                    k: grads[k] + g[k] for k in grads}
                losses.append(l)
                mets.append(met)
            grads = {k: g / grad_accum for k, g in grads.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}

        new_state = dict(state)
        if compress:
            qgrads, new_state["residual"] = compression.compress(
                grads, state["residual"])
            grads = compression.decompress(qgrads)

        if bf16_params:
            # update the fp32 master, then re-derive the bf16 compute
            # weights from it (the 1-D parameters are the master's own)
            master = state["opt"]["master"]
            opt_core = {k: v for k, v in state["opt"].items()
                        if k != "master"}
            _, new_opt, opt_metrics = adamw.apply_updates(
                master, grads, opt_core, opt_cfg)
            new_opt["master"] = master
            with torch.no_grad():
                for k, p in model.named_parameters():
                    if p.dtype != master[k].dtype:
                        p.copy_(master[k])
        else:
            params = {k: p for k, p in model.named_parameters()}
            _, new_opt, opt_metrics = adamw.apply_updates(
                params, grads, state["opt"], opt_cfg)
        new_state["opt"] = new_opt
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


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
