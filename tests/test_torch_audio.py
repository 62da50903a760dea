"""The port's audio family (the "cross" kind of repro_torch.models.model:
whisper's conv stem, encoder and cross-attending decoder) against the JAX
reference, on reduced whisper-small, on the CPU.

Weights come from the reference's ``init_params`` through
``models.convert.params_from_numpy``; the batch (mel frames and decoder
tokens) from the reference's ``synthetic_batch``.  Decode runs after the
cache handoff a caller makes (the package has no function for it, as the
reference has none): prefill's k/v go into ring slots [0, P) with
``pos[:P] = arange(P)`` and ``cur = P``, prefill's ``cross_kv`` into
``cross_k``/``cross_v``, on both sides.  Two modes, as in
tests/test_torch_ssm.py:

  * f32: ``FacilityConfig(ger=F32GER, out_dtype=float32)``, the reference
    under ``eager_layers()`` (its scan carry cannot change dtype) with an
    f32 decode cache; within 1e-4 of max|ref| (only the bf16 embedding is
    rounded; the rest is fp32 summed in another order).
  * bf16: the BF16GER2/bf16 default, the reference under
    ``FacilityConfig(use_pallas=True)`` (its Pallas kernels, the conv stem
    included, in interpret mode).  A cross-attention block's k/v
    projections are held to 2^-8 of max|ref| (one bf16 ulp), its output to
    2^-7: the reference's flash kernel rounds the unnormalised P to bf16
    per KV block and the port's plain version the normalised P once (the
    bound chip_smoke.py states between the two), and the output projection
    and the residual add one more bf16 rounding.  The encoder and whole
    models are held to 2^-5, the bound of tests/test_torch_ssm.py: the
    stem's bf16 convs sum 240 and 384 products in another order than the
    reference's conv, and each bf16 rounding that flips travels through
    the layernorms and the layers after it.  On these inputs the port sits
    ~7e-3 of max|ref| from the reference, and the reference's Pallas mode
    sits ~5e-3 from its own xla mode.
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

NAME = "whisper-small"
TOL = {"f32": 1e-4, "bf16": 2.0 ** -8}
ATTN_TOL = {"f32": 1e-4, "bf16": 2.0 ** -7}
MODEL_TOL = {"f32": 1e-4, "bf16": 2.0 ** -5}
# 2 clips of 24 mel frames (12 encoder positions after the stride-2
# stem), a 4-token decoder prompt, 3 decode steps.
B, FRAMES, P, DECODE = 2, 24, 4, 3


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


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jreduced(jget(NAME)), treduced(tget(NAME))
    params = JM.init_params(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    host = jdata.synthetic_batch(jcfg, batch=B, seq=FRAMES, step=0)
    return jcfg, tcfg, params, model, host


def _reference_handoff(jcfg, pre, dtype):
    """The reference's decode cache after a P-token prefill."""
    c = JM.init_cache(jcfg, B, FRAMES, dtype=dtype)
    k, v = pre["kv"]
    c["k"] = c["k"].at[:, :, :P].set(k.astype(dtype))
    c["v"] = c["v"].at[:, :, :P].set(v.astype(dtype))
    c["pos"] = c["pos"].at[:P].set(jnp.arange(P, dtype=jnp.int32))
    c["cur"] = jnp.asarray(P, jnp.int32)
    c["cross_k"] = pre["cross_kv"][0].astype(dtype)
    c["cross_v"] = pre["cross_kv"][1].astype(dtype)
    return c


def _port_handoff(tcfg, pre, dtype):
    """The same handoff on the port's cache, in place."""
    c = TM.init_cache(tcfg, B, FRAMES, device="cpu", dtype=dtype)
    c["k"][:, :, :P] = pre["kv"][0]
    c["v"][:, :, :P] = pre["kv"][1]
    c["pos"][:P] = torch.arange(P, dtype=torch.int32)
    c["cur"] = P
    c["cross_k"].copy_(pre["cross_kv"][0])
    c["cross_v"].copy_(pre["cross_kv"][1])
    return c


@pytest.fixture(scope="module", params=["f32", "bf16"])
def runs(models, request):
    """forward logits, the encoder output, prefill (last logits and
    caches) on the P-token prompt, and DECODE steps after the handoff, on
    both sides, in one mode."""
    mode = request.param
    jcfg, tcfg, params, model, host = models
    jdt, tdt = _act(mode)
    host = dict(host, tokens=host["tokens"][:, :P])
    next_tokens = host["labels"][:, P - 1:P - 1 + DECODE]
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    tbatch = tdata.device_batch(host, "cpu")
    with _reference_mode(mode):
        jl, _, _ = JM.forward(params, jbatch, jcfg)
        jenc = JM._run_encoder(params, jbatch["frames"], jcfg)
        jlast, jpre = JM.prefill(params, jbatch, jcfg)
        jc = _reference_handoff(jcfg, jpre, jdt)
        jsteps = []
        for t in range(DECODE):
            lg, jc = JM.decode_step(
                params, jc, jnp.asarray(next_tokens[:, t:t + 1]), jcfg)
            jsteps.append(np.asarray(lg, np.float32))
    with _port_mode(mode):
        tl, _, _ = TM.forward(model, tbatch, tcfg)
        tenc = TM._run_encoder(model, tbatch["frames"], tcfg)
        tlast, tpre = TM.prefill(model, tbatch, tcfg)
        tc = _port_handoff(tcfg, tpre, tdt)
        tsteps = []
        for t in range(DECODE):
            lg, tc = TM.decode_step(
                model, tc, torch.from_numpy(next_tokens[:, t:t + 1]), tcfg)
            tsteps.append(_np(lg))
    return dict(mode=mode,
                ref=dict(logits=jl, enc=jenc, last=jlast, pre=jpre,
                         steps=jsteps, cache=jc),
                port=dict(logits=tl, enc=tenc, last=tlast, pre=tpre,
                          steps=tsteps, cache=tc))


def test_run_encoder_matches_reference(runs):
    """The conv stem (two CONV1Ds, bias + gelu fused) and the non-causal
    encoder blocks: FRAMES mel frames -> FRAMES / 2 positions."""
    got, want = runs["port"]["enc"], runs["ref"]["enc"]
    assert tuple(got.shape) == (B, FRAMES // 2, 128)
    _close(_np(got), want, MODEL_TOL[runs["mode"]], "encoder output")


def test_forward_matches_reference(runs):
    got, want = runs["port"]["logits"], runs["ref"]["logits"]
    assert got.dtype == torch.float32
    _close(_np(got), want, MODEL_TOL[runs["mode"]], "forward logits")


def test_prefill_matches_reference(runs):
    tol = MODEL_TOL[runs["mode"]]
    port, ref = runs["port"], runs["ref"]
    _close(_np(port["last"]), ref["last"], tol, "prefill logits")
    assert sorted(port["pre"]) == sorted(ref["pre"]) == ["cross_kv", "kv"]
    for key in ("kv", "cross_kv"):
        for i, what in enumerate(("k", "v")):
            _close(_np(port["pre"][key][i]),
                   np.asarray(ref["pre"][key][i], np.float32), tol,
                   f"prefill {key} {what}")
    # the cross k/v span the encoder's positions, the self k/v the prompt
    assert port["pre"]["cross_kv"][0].shape[2] == FRAMES // 2
    assert port["pre"]["kv"][0].shape[2] == P


def test_decode_steps_match_reference(runs):
    """Decode after the handoff: the ring capped at decoder_len, the cross
    k/v of FRAMES // 2 encoder positions."""
    tol = MODEL_TOL[runs["mode"]]
    port, ref = runs["port"], runs["ref"]
    for t, (got, want) in enumerate(zip(port["steps"], ref["steps"])):
        _close(got, want, tol, f"decode step {t}")
    cache = port["cache"]
    assert cache["cur"] == int(ref["cache"]["cur"]) == P + DECODE
    assert cache["k"].shape[2] == 16          # min(FRAMES, decoder_len)
    for key in ("k", "v", "pos", "cross_k", "cross_v"):
        _close(_np(cache[key]), np.asarray(ref["cache"][key], np.float32),
               tol if key != "pos" else 0.0, f"decode {key} cache")


def test_decode_order_is_the_references():
    """whisper's decode step applies the MLP before cross-attention, its
    forward after.  The port copies both orders: its decode step matches
    the reference's decode step (f32, 1e-4 of max|ref|), while both sit
    far from the forward logits of the same P + 1 tokens."""
    jcfg, tcfg = jreduced(jget(NAME)), treduced(tget(NAME))
    params = JM.init_params(jcfg, jax.random.key(1))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    host = jdata.synthetic_batch(jcfg, batch=B, seq=FRAMES, step=1)
    prompt = dict(host, tokens=host["tokens"][:, :P])
    longer = dict(host, tokens=host["tokens"][:, :P + 1])
    nxt = host["tokens"][:, P:P + 1]
    with _reference_mode("f32"):
        _, jpre = JM.prefill(params, {k: jnp.asarray(v)
                                      for k, v in prompt.items()}, jcfg)
        jstep, _ = JM.decode_step(params,
                                  _reference_handoff(jcfg, jpre, jnp.float32),
                                  jnp.asarray(nxt), jcfg)
    with _port_mode("f32"):
        _, tpre = TM.prefill(model, tdata.device_batch(prompt, "cpu"), tcfg)
        tstep, _ = TM.decode_step(
            model, _port_handoff(tcfg, tpre, torch.float32),
            torch.from_numpy(nxt), tcfg)
        tfwd, _ = TM.prefill(model, tdata.device_batch(longer, "cpu"), tcfg)
    want = np.asarray(jstep, np.float32)[:, 0]
    _close(_np(tstep)[:, 0], want, 1e-4, "decode step")
    gap = float(np.abs(_np(tfwd) - want).max() / np.abs(want).max())
    assert gap > 1e-2, gap


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_cross_attention_matches_reference(models, mode):
    """One decoder block's cross-attention: q from the decoder stream, k
    and v projected from the encoder stream, no RoPE, non-causal, the
    residual fused into the output projection."""
    jcfg, tcfg, params, model, _ = models
    jdt, tdt = _act(mode)
    lp = jax.tree.map(lambda a: a[0], params["layers"])["cross"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 9, jcfg.d_model)).astype(np.float32)
    with _reference_mode(mode):
        jo, (jk, jv) = JL.apply_attention(
            lp, jnp.asarray(x).astype(jdt), jcfg, causal=False,
            cross_x=jnp.asarray(enc).astype(jdt),
            residual=jnp.asarray(x).astype(jdt))
    with _port_mode(mode):
        to, (tk, tv) = TL.apply_attention(
            model.layers[0].cross, torch.from_numpy(x).to(tdt), tcfg,
            causal=False, cross_x=torch.from_numpy(enc).to(tdt),
            residual=torch.from_numpy(x).to(tdt))
    assert tuple(tk.shape) == (B, 9, tcfg.num_kv_heads, tcfg.head_dim)
    _close(_np(to), np.asarray(jo, np.float32), ATTN_TOL[mode],
           "cross output")
    _close(_np(tk), np.asarray(jk, np.float32), TOL[mode], "cross k")
    _close(_np(tv), np.asarray(jv, np.float32), TOL[mode], "cross v")


def test_params_carry_over_and_stems_stay_fp32(models):
    """``convert`` carries the encoder stack, its norm, the conv stem and
    each decoder block's cross_norm/cross; with bf16 at rest the stem's
    filters and biases stay fp32, in ``convert`` and in ``init_params``."""
    jcfg, tcfg, params, model, _ = models
    enc = model.encoder
    assert len(enc.layers) == tcfg.encoder_layers == 2
    np.testing.assert_array_equal(
        _np(enc.frontend.conv2_w),
        np.asarray(params["encoder"]["frontend"]["conv2_w"]))
    np.testing.assert_array_equal(
        _np(model.layers[1].cross.wq),
        np.asarray(params["layers"]["cross"]["wq"][1]))
    np.testing.assert_array_equal(
        _np(enc.layers[1].mlp.w2),
        np.asarray(params["encoder"]["layers"]["mlp"]["w2"][1]))
    rest = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     device="cpu", dtype=torch.bfloat16)
    fresh = TM.init_params(tcfg, device="cpu", dtype=torch.bfloat16)
    for m in (rest, fresh):
        fe = m.encoder.frontend
        assert fe.conv1_w.shape == (3, tcfg.n_mels, tcfg.d_model)
        assert fe.conv2_w.shape == (3, tcfg.d_model, tcfg.d_model)
        assert {t.dtype for t in (fe.conv1_w, fe.conv1_b, fe.conv2_w,
                                  fe.conv2_b)} == {torch.float32}
        assert m.layers[0].cross.wk.dtype == torch.bfloat16
        assert m.vision_proj is None and m.vision_patch is None


def test_stub_frontend_matches_reference():
    """A stub config's ``frames`` are (B, T, d_model) embeddings that skip
    the conv stem, as the reference's: the pytree has no frontend, and
    forward matches in f32 (1e-4 of max|ref|)."""
    jcfg = dataclasses.replace(jreduced(jget(NAME)), frontend_stub=True)
    tcfg = dataclasses.replace(treduced(tget(NAME)), frontend_stub=True)
    params = JM.init_params(jcfg, jax.random.key(3))
    assert "frontend" not in params["encoder"]
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    assert model.encoder.frontend is None
    host = jdata.synthetic_batch(jcfg, batch=B, seq=10, step=4)
    assert host["frames"].shape == (B, 10, jcfg.d_model)
    with _reference_mode("f32"):
        want, _, _ = JM.forward(params, {k: jnp.asarray(v)
                                         for k, v in host.items()}, jcfg)
    with _port_mode("f32"):
        got, _, _ = TM.forward(model, tdata.device_batch(host, "cpu"), tcfg)
    _close(_np(got), want, 1e-4, "forward logits")
