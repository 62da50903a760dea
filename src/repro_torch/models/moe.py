"""Mixture-of-Experts layer: top-k capacity routing (port of
``repro.models.moe``).

Supports both MoE archs of the registry:
  * mixtral-8x22b: 8 experts, top-2, softmax-before-top-k, renormalised;
  * deepseek-moe-16b: 64 fine-grained experts, top-6, plus 2 shared
    experts run on every token (arXiv:2401.06066); its leading dense
    layers live in ``models.model``.

The expert FFNs are batched GEMMs, (E, C, d) x (E, d, f): the facility
normalises ``"ecd,edf->ecf"`` to a product with the expert axis as its
batch, which the kernel backend runs as ONE launch with the experts on the
GEMM kernel's batch grid axis, the activation fused into w1's store as in
the dense MLP.

Routing runs in fp32: the router product stores fp32, then softmax,
``torch.topk`` and the renormalisation ``topw / max(sum, 1e-9)``.  Ties
in the top-k: the reference's ``jax.lax.top_k`` breaks them to the lower
expert index, ``torch.topk`` on CUDA promises no order; exact ties in
fp32 router probabilities are not expected from real activations, and the
CPU parity tests use fp32 inputs.

Dispatch gives each (token, choice) pair, in flat (token, choice) order, a
FIFO slot in its expert's ``cap`` slots (a stable sort of the expert ids
and ``searchsorted``); pairs past ``cap`` drop.  Kept pairs are written
into an (E * cap + 1, d) buffer whose last row takes every dropped pair
and is then sliced off, so no kept slot can be overwritten and every
kept destination is unique: the write is deterministic.  The combine
gathers each pair's expert output (a dropped pair reads a zero row),
weights it by its bf16-cast ``topw``, and sums the k choices in fp32.
Nothing here reads a value back to the host (no ``.item()``, no boolean
mask indexing, no ``nonzero``), and no sum depends on the order of
atomics: the gradient of the token copies is a sum over k, and every
other gather's gradient lands on distinct rows (each kept slot is read by
one pair; the spare row, read by every dropped pair, has no gradient to
keep), so forward and backward give the same bits from run to run.

These are the results of the reference's gather dispatch
(``GATHER_DISPATCH = True``), whose contract is "same routing, same
drops".  The reference's default scatter dispatch writes every dropped
pair's zeros to slot 0 (``dest = where(keep, ..., 0)``), which overwrites
the token held in expert 0's first slot whenever a choice drops
(ROADMAP queue 3, reference caveats; pinned in tests/test_torch_moe.py).
The port keeps no ``GATHER_DISPATCH`` switch (it chooses between two
XLA-SPMD lowerings of one function).  ``EXCHANGE_DISPATCH`` is the
reference's: under a mesh whose expert axis divides E and the capacity,
the expert banks run through ``parallel.api.expert_exchange``, one
all-to-all out to the expert-parallel ranks (each runs its experts' banks
on every peer's slots) and one back.  The exchange is a pure permutation
of slots and the banks' kernel plan is resolved at the global bank
(the ``parallel.api.BankShard`` binding), so the result is the gather
dispatch's bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import facility
from repro_torch.core.facility import DOT, Epilogue, Plan
from repro_torch.models import layers as L
from repro_torch.parallel import api as par
from repro_torch.parallel.api import shard

# Expert-bank placement.  False = annotation-only: the dispatch buffer is
# annotated with the expert axis and the banks go through the mesh
# dispatch like any product.  True = the explicit exchange
# (``parallel.api.expert_exchange``): ONE all-to-all out to the
# expert-parallel ranks and one back, the comm pattern a multi-pod EP
# deployment schedules by hand.  Either setting gives the same bits.
EXCHANGE_DISPATCH = False


def moe_axes(cfg):
    # 'experts' takes the model axis when E divides it (EP, deepseek-moe
    # 64/16); otherwise param_spec falls through to 'mlp' -> model, i.e.
    # Megatron-style TP inside each expert (mixtral 8 experts on 16-way
    # model).
    p = {"router": ("embed", None),
         "w1": ("experts", "embed", "mlp"),
         "w3": ("experts", "embed", "mlp"),
         "w2": ("experts", "mlp", "embed")}
    if cfg.num_shared_experts:
        p["shared"] = L.mlp_axes(cfg)
    return p


class MoE(nn.Module):
    """The router (d, E), the expert banks ``w1``/``w3`` (E, d, f) and
    ``w2`` (E, f, d), and deepseek-moe's ``shared`` MLP (None without
    shared experts)."""

    def __init__(self, router, w1, w3, w2, shared: L.MLP | None = None):
        super().__init__()
        self.router = L._param(router)
        self.w1, self.w3, self.w2 = L._param(w1), L._param(w3), L._param(w2)
        self.shared = shared


def init_moe(gen, cfg, *, device, dtype) -> MoE:
    """Normal(0, 1/fan_in) weights from ``gen``; the banks' fan-in is
    their d (or f) axis.  ``w3`` is drawn whether or not the MLP is
    gated, as in the reference."""
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    router = L._dense_init(gen, (d, e), **kw)
    w1 = L._dense_init(gen, (e, d, f), in_axis=1, **kw)
    w3 = L._dense_init(gen, (e, d, f), in_axis=1, **kw)
    w2 = L._dense_init(gen, (e, f, d), in_axis=1, **kw)
    shared = (L.init_mlp(gen, cfg, d_ff=cfg.num_shared_experts * f, **kw)
              if cfg.num_shared_experts else None)
    return MoE(router, w1, w3, w2, shared)


def capacity(tokens: int, cfg) -> int:
    """Slots per expert: ceil(T * k * capacity_factor / E), at least 1."""
    return int(max(1, -(-tokens * cfg.top_k * cfg.capacity_factor
                        // cfg.num_experts)))


def route(p: MoE, xf: torch.Tensor, cfg):
    """The router in fp32: (probs (T, E), renormalised top-k weights
    (T, k), top-k expert ids (T, k), best first)."""
    logits = facility.contract(DOT, xf, p.router,
                               plan=Plan(out_dtype=torch.float32))
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


def slots(topi: torch.Tensor, e: int, cap: int):
    """FIFO capacity slots of the (token, choice) pairs, in flat (token,
    choice) order: (keep (T*k,) bool, dest (T*k,) int64), where a kept
    pair's dest is ``expert * cap + its place among the pairs routed to
    that expert`` and a dropped pair's is ``e * cap``."""
    ef = topi.reshape(-1)
    dev = ef.device
    order = torch.argsort(ef, stable=True)
    se = ef[order]
    first = torch.searchsorted(se, torch.arange(e, device=dev, dtype=se.dtype))
    pos = torch.empty_like(ef).index_put_(
        (order,), torch.arange(ef.numel(), device=dev) - first[se])
    keep = pos < cap
    return keep, torch.where(keep, ef * cap + pos, e * cap)


def apply_moe(p: MoE, x: torch.Tensor, cfg):
    """x (B, S, d) -> (out (B, S, d), the load-balancing aux loss, an fp32
    scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    dev = x.device
    xf = x.reshape(t, d)
    probs, topw, topi = route(p, xf, cfg)

    # ---- load-balancing auxiliary loss (Switch/Mixtral form) ----
    one_hot = (topi[..., None] == torch.arange(e, device=dev)).to(
        torch.float32)                                        # (T, k, E)
    frac_routed = one_hot.sum(1).mean(0)
    aux = e * torch.sum(frac_routed * probs.mean(0)) * cfg.router_aux_coef

    # ---- capacity dispatch ----
    cap = capacity(t, cfg)
    keep, dest = slots(topi, e, cap)
    xrep = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    xe = xf.new_zeros((e * cap + 1, d)).index_put((dest,), xrep)
    xe = shard(xe[:-1].reshape(e, cap, d), "experts", None, None)

    # ---- expert banks: batched products, experts on the batch axis ----
    if EXCHANGE_DISPATCH:
        # the exchange's per-shard body: its contracts bind the binding
        # the exchange gives (the slab is already a shard) and it makes no
        # shard() annotations
        def expert_ffn(slab, ws, mesh):
            h1 = facility.contract(
                "ecd,edf->ecf", slab, ws["w1"],
                plan=Plan(mesh=mesh, epilogue=Epilogue(activation=cfg.act)))
            if cfg.gated_mlp:
                h1 = h1 * facility.contract("ecd,edf->ecf", slab, ws["w3"],
                                            plan=Plan(mesh=mesh))
            return facility.contract("ecf,efd->ecd", h1, ws["w2"],
                                     plan=Plan(mesh=mesh))

        weights = {"w1": p.w1, "w2": p.w2}
        if cfg.gated_mlp:
            weights["w3"] = p.w3
        ye = par.expert_exchange(xe, weights, expert_ffn)
    else:
        h = facility.contract(
            "ecd,edf->ecf", xe, p.w1,
            plan=Plan(epilogue=Epilogue(activation=cfg.act)))
        h = shard(h, "experts", None, "mlp")   # EP, or TP inside experts
        if cfg.gated_mlp:
            h = h * facility.contract("ecd,edf->ecf", xe, p.w3)
        ye = facility.contract("ecf,efd->ecd", h, p.w2)
        ye = shard(ye, "experts", None, None)

    # ---- combine: gather, weight, sum the k choices in fp32 ----
    ye = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))])
    # index_select's gradient is an index_add onto rows that each receive
    # one addend (the spare row, many, is sliced off): exact, and unlike
    # indexing's sorted accumulation, a single pass
    back = torch.index_select(ye, 0, dest).reshape(t, k, d)
    w = (topw * keep.reshape(t, k)).to(ye.dtype)
    out = (back.float() * w.float()[..., None]).sum(1).to(ye.dtype)
    out = out.reshape(b, s, d)
    if p.shared is not None:
        out = out + L.apply_mlp(p.shared, x, cfg)
    return out, aux
