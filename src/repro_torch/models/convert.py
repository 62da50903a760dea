"""Carry the reference's parameters over into the port's modules.

Torch cannot reproduce ``jax.random`` streams, so parity runs build their
weights with ``repro.models.model.init_params`` and hand the pytree over as
numpy arrays (bf16 leaves go through float32, which is exact).  This module
takes only numpy, never the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import facility
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import model as M


def params_from_numpy(tree, cfg, *, device, dtype: torch.dtype | None = None
                      ) -> M.Model:
    """Build a :class:`~repro_torch.models.model.Model` from the
    reference's parameter pytree (dense, ssm or hybrid family) with numpy
    leaves, unstacking the leading layer axis of ``tree["layers"]``.

    With ``dtype`` (e.g. ``torch.bfloat16``), the projection weights are
    stored in it once, at load; 1-D parameters and mamba2's conv taps
    ``conv_w`` stay fp32 (the conv runs F32GER, which reads its taps as
    fp32, and the reference keeps them fp32).  The reference casts each
    weight to the compute dtype on every call, and casting once gives the
    same values.
    """
    M.check_family(cfg)
    device = facility.resolve_device(device)

    def t(a, cast=True):
        x = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
        if cast and dtype is not None and x.ndim >= 2:
            x = x.to(dtype)
        return x.to(device)

    def at(p, i):
        """Layer ``i`` of a stacked subtree (``None``: not stacked)."""
        return p if i is None else {k: v[i] for k, v in p.items()}

    def norm(p, i=None):
        p = at(p, i)
        return L.Norm(t(p["scale"]), t(p["bias"]) if "bias" in p else None)

    def attention(p, i=None):
        p = at(p, i)
        return L.Attention(t(p["wq"]), t(p["wk"]), t(p["wv"]), t(p["wo"]))

    def mlp(p, i=None):
        p = at(p, i)
        return L.MLP(t(p["w1"]), t(p["w2"]),
                     t(p["w3"]) if "w3" in p else None)

    e = tree["embed"]
    embed = L.Embed(t(e["tok"]), t(e["unembed"]) if "unembed" in e else None)
    lt = tree["layers"]
    layers = []
    for i in range(cfg.num_layers):
        if cfg.family == "dense":
            layers.append(M.DenseBlock(
                norm(lt["attn_norm"], i), attention(lt["attn"], i),
                norm(lt["mlp_norm"], i), mlp(lt["mlp"], i)))
            continue
        mb = at(lt["mamba"], i)
        layers.append(M.SSMBlock(norm(lt["norm"], i), M2.Mamba2(
            t(mb["in_proj"]), t(mb["conv_w"], cast=False), t(mb["conv_b"]),
            t(mb["A_log"]), t(mb["D"]), t(mb["dt_bias"]),
            t(mb["norm_scale"]), t(mb["out_proj"]))))
    shared = None
    if "shared_attn" in tree:
        sa = tree["shared_attn"]
        shared = M.SharedAttn(t(sa["in_proj"]), norm(sa["attn_norm"]),
                              attention(sa["attn"]), norm(sa["mlp_norm"]),
                              mlp(sa["mlp"]))
    return M.Model(embed, layers, norm(tree["final_norm"]), shared)
