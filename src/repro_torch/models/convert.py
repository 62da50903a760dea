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
from repro_torch.models import model as M


def params_from_numpy(tree, cfg, *, device, dtype: torch.dtype | None = None
                      ) -> M.Model:
    """Build a :class:`~repro_torch.models.model.Model` from the
    reference's dense-family parameter pytree with numpy leaves, unstacking
    the leading layer axis of ``tree["layers"]``.

    With ``dtype`` (e.g. ``torch.bfloat16``), tensors of 2 or more
    dimensions are stored in it once, at load; 1-D norm scales stay fp32.
    The reference casts each weight to the compute dtype on every call,
    and casting once gives the same values.
    """
    M.check_family(cfg)
    device = facility.resolve_device(device)

    def t(a):
        x = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
        if dtype is not None and x.ndim >= 2:
            x = x.to(dtype)
        return x.to(device)

    def norm(p, i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        return L.Norm(t(pick(p["scale"])),
                      t(pick(p["bias"])) if "bias" in p else None)

    e = tree["embed"]
    embed = L.Embed(t(e["tok"]), t(e["unembed"]) if "unembed" in e else None)
    lt = tree["layers"]
    layers = []
    for i in range(cfg.num_layers):
        a, m = lt["attn"], lt["mlp"]
        layers.append(M.DenseBlock(
            norm(lt["attn_norm"], i),
            L.Attention(t(a["wq"][i]), t(a["wk"][i]), t(a["wv"][i]),
                        t(a["wo"][i])),
            norm(lt["mlp_norm"], i),
            L.MLP(t(m["w1"][i]), t(m["w2"][i]),
                  t(m["w3"][i]) if "w3" in m else None)))
    return M.Model(embed, layers, norm(tree["final_norm"]))
