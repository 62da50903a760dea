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
from repro_torch.models import moe as MOE


def params_from_numpy(tree, cfg, *, device, dtype: torch.dtype | None = None
                      ) -> M.Model:
    """Build a :class:`~repro_torch.models.model.Model` from the
    reference's parameter pytree (any family) with numpy leaves,
    unstacking the leading layer axis of ``tree["layers"]``,
    ``tree["first_dense"]`` and ``tree["encoder"]["layers"]``.

    With ``dtype`` (e.g. ``torch.bfloat16``), the projection weights are
    stored in it once, at load; 1-D parameters, mamba2's conv taps
    ``conv_w`` and the conv stems' filters (whisper's ``conv1_w``/
    ``conv2_w``, qwen2-vl's ``patch_w``) stay fp32, as the reference keeps
    them; the lowering casts them by policy on every call.  The reference
    casts each weight to the compute dtype on every call, and casting once
    gives the same values.
    """
    kind = M.check_family(cfg)
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

    def moe(p, i):
        shared = mlp(p["shared"], i) if "shared" in p else None
        p = at({k: v for k, v in p.items() if k != "shared"}, i)
        return MOE.MoE(t(p["router"]), t(p["w1"]), t(p["w3"]), t(p["w2"]),
                       shared)

    def dense(lt, i):
        cross = (norm(lt["cross_norm"], i), attention(lt["cross"], i)
                 ) if "cross" in lt else ()
        return M.DenseBlock(norm(lt["attn_norm"], i), attention(lt["attn"], i),
                            norm(lt["mlp_norm"], i), mlp(lt["mlp"], i),
                            *cross)

    e = tree["embed"]
    embed = L.Embed(t(e["tok"]), t(e["unembed"]) if "unembed" in e else None)
    first_dense = [dense(tree["first_dense"], i)
                   for i in range(cfg.first_dense_layers)]
    lt = tree["layers"]
    layers = []
    for i in range(cfg.num_layers - cfg.first_dense_layers):
        if kind in ("dense", "cross"):
            layers.append(dense(lt, i))
            continue
        if kind == "moe":
            layers.append(M.MoEBlock(
                norm(lt["attn_norm"], i), attention(lt["attn"], i),
                norm(lt["mlp_norm"], i), moe(lt["moe"], i)))
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
    encoder = None
    if "encoder" in tree:
        enc = tree["encoder"]
        frontend = None
        if "frontend" in enc:
            fe = enc["frontend"]
            frontend = M.Frontend(t(fe["conv1_w"], cast=False),
                                  t(fe["conv1_b"]),
                                  t(fe["conv2_w"], cast=False),
                                  t(fe["conv2_b"]))
        encoder = M.Encoder([dense(enc["layers"], i)
                             for i in range(cfg.encoder_layers)],
                            norm(enc["norm"]), frontend)
    vision_patch = None
    if "vision_patch" in tree:
        vp = tree["vision_patch"]
        vision_patch = M.VisionPatch(t(vp["patch_w"], cast=False),
                                     t(vp["patch_b"]))
    return M.Model(embed, layers, norm(tree["final_norm"]), shared, encoder,
                   t(tree["vision_proj"]) if "vision_proj" in tree else None,
                   vision_patch, first_dense)
