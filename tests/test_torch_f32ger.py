"""The tight-parity config, ``FacilityConfig(ger=F32GER, out_dtype=float32)``,
through prefill and decode of reduced deepseek-7b and whisper-small against
the JAX reference under ``eager_layers()``, on the CPU, with the route each
call takes to the kernels recorded.

On the card this config runs every attention call on K2e (the attention
kernel's fp32 tile: f32 q, k and v) and every GEMM on true fp32 FMAs: the
weight stream at M <= 64, the fp32 tile above.  Here the wrappers run
their plain versions (the split-K one where the stream splits K), so the
tests spy on the wrappers' dispatch (``_mma_flash_attention``,
``_mma_gemm``) and hold each call to what the card would launch: attention
operands f32, the prefill in the tile mode and whisper's one-query decode
cross-attention in the split-KV mode (80 encoder positions: two KV
blocks); GEMM operands f32 on ``choose_gemm_path``'s path, deepseek's
(M <= 24) all on the stream, whisper's encoder (M = 160) on the fp32
tile and its decoder on the stream.  The outputs are held within 1e-4 of max|ref|, the bound of
tests/test_torch_model.py's f32 mode (only the bf16 embedding is rounded;
the rest is fp32 summed in another order).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.base import reduced as jreduced
from repro.core import facility as jfac
from repro.core import precision as jprec
from repro.data import pipeline as jdata
from repro.models import model as JM
from repro_torch.configs import get as tget
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.core import tiling
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import mma_attention as tattn
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.models import convert
from repro_torch.models import model as TM

TOL = 1e-4
F32 = tprec.Ger.F32GER


def _reference():
    stack = contextlib.ExitStack()
    stack.enter_context(jfac.configure(jfac.FacilityConfig(
        ger=jprec.Ger.F32GER, out_dtype=jnp.float32)))
    stack.enter_context(JM.eager_layers())
    return stack


def _port():
    return tfac.configure(tfac.FacilityConfig(
        device="cpu", ger=F32, out_dtype=torch.float32))


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= TOL * scale, f"{what}: max|err| {err} > {TOL} * {scale}"


@pytest.fixture
def routes(monkeypatch):
    """Every attention and GEMM dispatch of the port, with the mode or
    path the card would launch for it."""
    seen = {"attn": [], "gemm": []}
    attn, gemm = tattn._mma_flash_attention, tgemm._mma_gemm

    def attn_spy(q, k, v, **kw):
        n_split, _ = tattn.split_kv_plan(q.shape[2], q.shape[1], k.shape[1])
        seen["attn"].append(((q.dtype, k.dtype, v.dtype), q.shape[1],
                             "split" if n_split > 1 else "tile"))
        return attn(q, k, v, **kw)

    def gemm_spy(x, y, c=None, *, kind=tprec.Ger.BF16GER2, **kw):
        b = x.shape[0] if x.ndim == 3 else 1
        path, _ = tiling.choose_gemm_path(
            x.shape[-2], y.shape[-1], x.shape[-1], kind, b, True,
            kw.get("block"), kw.get("masks") is not None)
        seen["gemm"].append(((x.dtype, y.dtype), kind, path,
                             x.shape[-2]))
        return gemm(x, y, c, kind=kind, **kw)

    monkeypatch.setattr(tattn, "_mma_flash_attention", attn_spy)
    monkeypatch.setattr(tgemm, "_mma_gemm", gemm_spy)
    return seen


def _check_routes(seen, attn_modes, gemm_paths):
    assert seen["attn"] and seen["gemm"]
    f32 = (torch.float32,) * 3
    assert all(dt == f32 for dt, _, _ in seen["attn"])
    assert {mode for _, _, mode in seen["attn"]} == attn_modes
    assert all(dt == f32[:2] and kind == F32 for dt, kind, _, _ in
               seen["gemm"])
    # M <= 64 on the fp32 weight stream, above on the fp32 tile (K >= 16)
    assert all(path == ("stream" if m <= tiling.STREAM_MAX_M else "wmma")
               for _, _, path, m in seen["gemm"])
    assert {path for _, _, path, _ in seen["gemm"]} == gemm_paths


def _models(name):
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    params = JM.init_params(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    return jcfg, tcfg, params, model


def test_deepseek_prefill_and_decode(routes):
    """Reduced deepseek-7b: a 2 x 12 prefill (its causal attention in the
    tile mode) and 3 teacher-forced decode steps (eager ring attention),
    every product an f32 GEMM on the fp32 weight stream."""
    jcfg, tcfg, params, model = _models("deepseek-7b")
    b, s, steps = 2, 12, 3
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (b, s + steps), dtype=np.int32)
    with _reference():
        jlast, jcache = JM.prefill(params, {"tokens": jnp.asarray(
            tokens[:, :s])}, jcfg)
        jc = JM.init_cache(jcfg, b, s + steps, dtype=jnp.float32)
        jsteps = []
        for t in range(steps):
            lg, jc = JM.decode_step(params, jc,
                                    jnp.asarray(tokens[:, t:t + 1]), jcfg)
            jsteps.append(np.asarray(lg, np.float32))
    with _port():
        tlast, tcache = TM.prefill(model, {"tokens": torch.from_numpy(
            tokens[:, :s])}, tcfg)
        n_prefill = len(routes["attn"])
        tc = TM.init_cache(tcfg, b, s + steps, device="cpu",
                           dtype=torch.float32)
        for t in range(steps):
            lg, tc = TM.decode_step(model, tc,
                                    torch.from_numpy(tokens[:, t:t + 1]),
                                    tcfg)
            _close(lg.numpy(), jsteps[t], f"decode step {t} logits")
    _close(tlast.numpy(), jlast, "prefill logits")
    for i, what in enumerate(("k", "v")):
        _close(tcache["kv"][i].numpy(), jcache["kv"][i], f"prefill {what}")
    assert n_prefill == tcfg.num_layers
    _check_routes(routes, {"tile"}, {"stream"})


def test_whisper_prefill_and_decode(routes):
    """Reduced whisper-small over 160 mel frames (80 encoder positions): the
    encoder and the decoder's self-attention in the tile mode; the
    cross-attention over the 80 positions in the split-KV mode, for the
    4-token prompt and then for 2 decode steps after the cache handoff."""
    jcfg, tcfg, params, model = _models("whisper-small")
    b, frames, p, steps = 2, 160, 4, 2
    host = jdata.synthetic_batch(jcfg, batch=b, seq=frames, step=0)
    nxt = host["labels"][:, p - 1:p - 1 + steps]
    host = dict(host, tokens=host["tokens"][:, :p])
    with _reference():
        jlast, jpre = JM.prefill(
            params, {k: jnp.asarray(v) for k, v in host.items()}, jcfg)
        jc = JM.init_cache(jcfg, b, frames, dtype=jnp.float32)
        jc["k"] = jc["k"].at[:, :, :p].set(jpre["kv"][0])
        jc["v"] = jc["v"].at[:, :, :p].set(jpre["kv"][1])
        jc["pos"] = jc["pos"].at[:p].set(jnp.arange(p, dtype=jnp.int32))
        jc["cur"] = jnp.asarray(p, jnp.int32)
        jc["cross_k"], jc["cross_v"] = jpre["cross_kv"]
        jsteps = []
        for t in range(steps):
            lg, jc = JM.decode_step(params, jc, jnp.asarray(nxt[:, t:t + 1]),
                                    jcfg)
            jsteps.append(np.asarray(lg, np.float32))
    with _port():
        tlast, tpre = TM.prefill(model, tdata.device_batch(host, "cpu"),
                                 tcfg)
        tc = TM.init_cache(tcfg, b, frames, device="cpu",
                           dtype=torch.float32)
        tc["k"][:, :, :p] = tpre["kv"][0]
        tc["v"][:, :, :p] = tpre["kv"][1]
        tc["pos"][:p] = torch.arange(p, dtype=torch.int32)
        tc["cur"] = p
        tc["cross_k"].copy_(tpre["cross_kv"][0])
        tc["cross_v"].copy_(tpre["cross_kv"][1])
        for t in range(steps):
            lg, tc = TM.decode_step(model, tc,
                                    torch.from_numpy(nxt[:, t:t + 1]), tcfg)
            _close(lg.numpy(), jsteps[t], f"decode step {t} logits")
    _close(tlast.numpy(), jlast, "prefill logits")
    for i, what in enumerate(("cross k", "cross v")):
        _close(tpre["cross_kv"][i].numpy(), jpre["cross_kv"][i], what)
    # the cross-attention, over 80 positions, splits KV: the prompt's
    # (Sq = 4) in each decoder layer, then each step's (Sq = 1)
    split = [sq for _, sq, mode in routes["attn"] if mode == "split"]
    assert sorted(split) == [1] * (steps * tcfg.num_layers) \
        + [p] * tcfg.num_layers
    _check_routes(routes, {"tile", "split"}, {"stream", "wmma"})
