"""The port's vision-language family (the vlm family of
repro_torch.models.model: qwen2-vl's patch-embed conv stem, its projection
into the leading vision positions, and M-RoPE) against the JAX reference,
on reduced qwen2-vl-7b, on the CPU; and the port's ``synthetic_batch``
against the reference's, bit for bit.

Weights come from the reference's ``init_params`` through
``models.convert.params_from_numpy``; the batch (tokens, images, M-RoPE
positions) from the reference's ``synthetic_batch``.  Decode runs after
the cache handoff a caller makes: prefill's k/v go into ring slots [0, S)
with ``pos[:S] = arange(S)`` and ``cur = S``, on both sides.  Two modes,
as in tests/test_torch_ssm.py: f32 (``FacilityConfig(ger=F32GER,
out_dtype=float32)``, the reference under ``eager_layers()``) within 1e-4
of max|ref|; bf16 (the default policy, the reference under
``use_pallas=True``, its conv and flash kernels in interpret mode) with
the patch embed held to 2^-8 of max|ref| (one bf16 ulp: one conv, one
rounding) and whole models to 2^-5, the bound of tests/test_torch_ssm.py
(each bf16 rounding that flips where the two frameworks sum in another
order travels through the layers; the reference's own Pallas mode sits
~8e-3 of max|ref| from its xla mode on these inputs).
"""

from __future__ import annotations

import contextlib
import dataclasses

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
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get as tget
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.data import pipeline as tdata
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

NAME = "qwen2-vl-7b"
TOL = {"f32": 1e-4, "bf16": 2.0 ** -8}
MODEL_TOL = {"f32": 1e-4, "bf16": 2.0 ** -5}
# 2 requests of the reduced 8-position vision prefix (a 2 x 4 grid of
# 4-pixel patches) plus 4 text tokens, 3 decode steps.
B, S, DECODE = 2, 12, 3


def _reference_mode(mode):
    stack = contextlib.ExitStack()
    if mode == "f32":
        stack.enter_context(jfac.configure(jfac.FacilityConfig(
            ger=jprec.Ger.F32GER, out_dtype=jnp.float32)))
        stack.enter_context(JM.eager_layers())
    else:
        stack.enter_context(jfac.configure(jfac.FacilityConfig(
            use_pallas=True)))
    return stack


def _port_mode(mode):
    kw = (dict(ger=tprec.Ger.F32GER, out_dtype=torch.float32)
          if mode == "f32" else {})
    return tfac.configure(tfac.FacilityConfig(device="cpu", **kw))


def _act(mode):
    return (jnp.float32, torch.float32) if mode == "f32" else (
        jnp.bfloat16, torch.bfloat16)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max|err| {err} > {tol} * {scale}"


def _pair(name, **changes):
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(tcfg, **changes))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _pair(NAME)
    params = JM.init_params(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    host = jdata.synthetic_batch(jcfg, batch=B, seq=S, step=0)
    return jcfg, tcfg, params, model, host


@pytest.fixture(scope="module", params=["f32", "bf16"])
def runs(models, request):
    """forward logits, the patch embeddings, prefill (last logits and the
    k/v cache), and DECODE steps after the handoff, on both sides, in one
    mode."""
    mode = request.param
    jcfg, tcfg, params, model, host = models
    jdt, tdt = _act(mode)
    next_tokens = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (B, DECODE), dtype=np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    tbatch = tdata.device_batch(host, "cpu")
    with _reference_mode(mode):
        jl, _, _ = JM.forward(params, jbatch, jcfg)
        jve = JM._vision_patch_embed(params, jbatch["images"], jcfg)
        jlast, jpre = JM.prefill(params, jbatch, jcfg)
        jc = JM.init_cache(jcfg, B, S + DECODE, dtype=jdt)
        jc["k"] = jc["k"].at[:, :, :S].set(jpre["kv"][0].astype(jdt))
        jc["v"] = jc["v"].at[:, :, :S].set(jpre["kv"][1].astype(jdt))
        jc["pos"] = jc["pos"].at[:S].set(jnp.arange(S, dtype=jnp.int32))
        jc["cur"] = jnp.asarray(S, jnp.int32)
        jsteps = []
        for t in range(DECODE):
            lg, jc = JM.decode_step(
                params, jc, jnp.asarray(next_tokens[:, t:t + 1]), jcfg)
            jsteps.append(np.asarray(lg, np.float32))
    with _port_mode(mode):
        tl, _, _ = TM.forward(model, tbatch, tcfg)
        tve = TM._vision_patch_embed(model, tbatch["images"], tcfg)
        tlast, tpre = TM.prefill(model, tbatch, tcfg)
        tc = TM.init_cache(tcfg, B, S + DECODE, device="cpu", dtype=tdt)
        tc["k"][:, :, :S] = tpre["kv"][0]
        tc["v"][:, :, :S] = tpre["kv"][1]
        tc["pos"][:S] = torch.arange(S, dtype=torch.int32)
        tc["cur"] = S
        tsteps = []
        for t in range(DECODE):
            lg, tc = TM.decode_step(
                model, tc, torch.from_numpy(next_tokens[:, t:t + 1]), tcfg)
            tsteps.append(_np(lg))
    return dict(mode=mode,
                ref=dict(logits=jl, ve=jve, last=jlast, pre=jpre,
                         steps=jsteps, cache=jc),
                port=dict(logits=tl, ve=tve, last=tlast, pre=tpre,
                          steps=tsteps, cache=tc))


def test_vision_patch_embed_matches_reference(runs):
    """One CONV2D, kernel = stride = patch size, bias fused: the 2 x 4
    patch grid -> the 8 vision-prefix positions."""
    got, want = runs["port"]["ve"], runs["ref"]["ve"]
    assert tuple(got.shape) == (B, 8, 128)
    _close(_np(got), want, TOL[runs["mode"]], "patch embeddings")


def test_forward_matches_reference(runs):
    got, want = runs["port"]["logits"], runs["ref"]["logits"]
    assert got.dtype == torch.float32
    _close(_np(got), want, MODEL_TOL[runs["mode"]], "forward logits")


def test_prefill_matches_reference(runs):
    tol = MODEL_TOL[runs["mode"]]
    port, ref = runs["port"], runs["ref"]
    _close(_np(port["last"]), ref["last"], tol, "prefill logits")
    assert sorted(port["pre"]) == sorted(ref["pre"]) == ["kv"]
    for i, what in enumerate(("k", "v")):
        _close(_np(port["pre"]["kv"][i]),
               np.asarray(ref["pre"]["kv"][i], np.float32), tol,
               f"prefill {what} cache")


def test_decode_steps_match_reference(runs):
    """Decode after the handoff, each step rotated by the M-RoPE positions
    (cur, cur, cur)."""
    tol = MODEL_TOL[runs["mode"]]
    port, ref = runs["port"], runs["ref"]
    for t, (got, want) in enumerate(zip(port["steps"], ref["steps"])):
        _close(got, want, tol, f"decode step {t}")
    assert port["cache"]["cur"] == int(ref["cache"]["cur"]) == S + DECODE
    for key in ("k", "v", "pos"):
        _close(_np(port["cache"][key]),
               np.asarray(ref["cache"][key], np.float32),
               tol if key != "pos" else 0.0, f"decode {key} cache")


@pytest.mark.parametrize("case", ["text", "grid", "decode"])
def test_mrope_cos_sin_matches_reference(case):
    """M-RoPE at the full config's head_dim 128 and sections (16, 24, 24):
    equal t/h/w rows (text), distinct rows (an image grid's t, row, col),
    and decode's broadcast (cur, cur, cur); within 1e-6 (the same fp32
    angles, cos/sin of two libraries)."""
    cfg = tget(NAME)
    rng = np.random.default_rng(3)
    if case == "text":
        pos = np.broadcast_to(np.arange(10)[None, None], (3, 2, 10))
    elif case == "grid":
        pos = rng.integers(0, 2000, (3, 2, 10))
    else:
        pos = np.full((3, 2, 1), 1087)
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    jc, js = JL.mrope_cos_sin(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    tc, ts = TL.mrope_cos_sin(torch.from_numpy(pos), cfg.head_dim,
                              cfg.rope_theta, cfg.mrope_sections)
    assert tuple(tc.shape) == (2, pos.shape[-1], cfg.head_dim // 2)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        TL.mrope_cos_sin(torch.from_numpy(pos), cfg.head_dim, cfg.rope_theta,
                         (16, 24, 25))


def test_precomputed_vision_embeds_match_reference():
    """A stub config's batch carries ``vision_embeds`` instead of images:
    they are projected into the leading positions, as the reference does
    (f32, 1e-4 of max|ref|)."""
    jcfg, tcfg = _pair(NAME, frontend_stub=True)
    params = JM.init_params(jcfg, jax.random.key(2))
    assert "vision_patch" not in params
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    host = jdata.synthetic_batch(jcfg, batch=B, seq=S, step=2)
    assert "vision_embeds" in host and "images" not in host
    with _reference_mode("f32"):
        want, _, _ = JM.forward(params, {k: jnp.asarray(v)
                                         for k, v in host.items()}, jcfg)
    with _port_mode("f32"):
        got, _, _ = TM.forward(model, tdata.device_batch(host, "cpu"), tcfg)
    _close(_np(got), want, 1e-4, "forward logits")


def test_params_carry_over_and_stem_stays_fp32(models):
    jcfg, tcfg, params, model, host = models
    np.testing.assert_array_equal(_np(model.vision_proj),
                                  np.asarray(params["vision_proj"]))
    np.testing.assert_array_equal(_np(model.vision_patch.patch_w),
                                  np.asarray(params["vision_patch"]["patch_w"]))
    rest = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     device="cpu", dtype=torch.bfloat16)
    fresh = TM.init_params(tcfg, device="cpu", dtype=torch.bfloat16)
    for m in (rest, fresh):
        assert m.vision_patch.patch_w.shape == (4, 4, 3, tcfg.d_model)
        assert m.vision_patch.patch_w.dtype == torch.float32
        assert m.vision_patch.patch_b.dtype == torch.float32
        assert m.vision_proj.dtype == torch.bfloat16
        assert m.encoder is None
    # an image that does not tile the vision prefix is refused
    images = torch.zeros((1, 8, 12, 3))
    with _port_mode("f32"), pytest.raises(ValueError, match="vision_prefix"):
        TM._vision_patch_embed(model, images, tcfg)


@pytest.mark.parametrize("name,changes,seq,step,seed", [
    ("qwen2-vl-7b", {}, 12, 0, 0),
    ("qwen2-vl-7b", {"frontend_stub": True}, 12, 5, 1),
    ("whisper-small", {}, 24, 0, 0),
    ("whisper-small", {"frontend_stub": True}, 10, 3, 2),
    ("deepseek-7b", {}, 16, 7, 3),
], ids=["qwen2-vl", "qwen2-vl-stub", "whisper", "whisper-stub", "deepseek"])
def test_synthetic_batch_matches_reference(name, changes, seq, step, seed):
    """The port's numpy copy of ``synthetic_batch`` gives the reference's
    arrays bit for bit (keys, dtypes, shapes and values)."""
    jcfg, tcfg = _pair(name, **changes)
    want = jdata.synthetic_batch(jcfg, batch=3, seq=seq, step=step,
                                 seed=seed)
    got = tdata.synthetic_batch(tcfg, batch=3, seq=seq, step=step, seed=seed)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    on = tdata.device_batch(got, "cpu")
    for key in want:
        np.testing.assert_array_equal(on[key].numpy(), want[key])
