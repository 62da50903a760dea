"""The port's ssm and hybrid families (repro_torch.models.mamba2 and the
"ssm"/"hybrid" kinds of repro_torch.models.model) and their serving loop
against the JAX reference, on reduced mamba2-130m and zamba2-1.2b, on the
CPU.

Weights come from the reference's ``init_params`` through
``models.convert.params_from_numpy``; tokens and activations from numpy
with a fixed seed.  Two modes:

  * f32: ``FacilityConfig(ger=F32GER, out_dtype=float32)``, the reference
    under ``eager_layers()`` (its scan carry cannot change dtype) with an
    f32 decode cache; within 1e-4 of max|ref|.
  * bf16: the default BF16GER2/bf16 policy, the reference under
    ``FacilityConfig(use_pallas=True)`` (its Pallas kernels in interpret
    mode): its default xla mode sends the SSD's bf16 x bf16 -> f32
    contracts to a CPU dot that refuses them.  One block and the SSD scan
    are held to 2^-8 of max|ref| (one bf16 ulp), as the dense model is.
    Whole models are held to 2^-5 of max|ref|: the SSM chain is longer
    than the dense model's (softplus, exp, cumsum, the gated RMSNorm's
    mean and rsqrt feed bf16 roundings in every layer), and the two
    frameworks' fp32 exp/rsqrt and sum orders differ by an ulp, which
    flips a few bf16 roundings that then travel through the recurrence.
    On these inputs the port sits 0.7-1.1e-2 of max|ref| from the
    reference, and the reference's own bf16 logits sit 0.9-1.2e-2 from
    its f32 logits, so the two differ by the bf16 noise of either.
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
from repro.launch import serve as jserve
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro_torch.configs import get as tget
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM

ARCHS = ["mamba2-130m", "zamba2-1.2b"]
TOL = {"f32": 1e-4, "bf16": 2.0 ** -8}
MODEL_TOL = {"f32": 1e-4, "bf16": 2.0 ** -5}
B, S, DECODE = 2, 32, 3          # S: two SSD chunks of the reduced configs


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


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max|err| {err} > {tol} * {scale}"


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    name = request.param
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    params = JM.init_params(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S), dtype=np.int32)
    return jcfg, tcfg, params, model, tokens


@pytest.fixture(scope="module", params=["f32", "bf16"])
def runs(models, request):
    """forward logits, prefill (last logits and caches) and DECODE steps
    from a zero cache, on both sides, in one mode."""
    mode = request.param
    jcfg, tcfg, params, model, tokens = models
    jdt, tdt = _act(mode)
    batch = tokens
    with _reference_mode(mode):
        jl, _, _ = JM.forward(params, {"tokens": jnp.asarray(batch)}, jcfg)
        jlast, jpre = JM.prefill(params, {"tokens": jnp.asarray(batch)},
                                 jcfg)
        jc = JM.init_cache(jcfg, B, S, dtype=jdt)
        jsteps = []
        for t in range(DECODE):
            lg, jc = JM.decode_step(params, jc,
                                    jnp.asarray(tokens[:, t:t + 1]), jcfg)
            jsteps.append(np.asarray(lg, np.float32))
    with _port_mode(mode):
        tl, _, _ = TM.forward(model, {"tokens": torch.from_numpy(batch)},
                              tcfg)
        tlast, tpre = TM.prefill(model, {"tokens": torch.from_numpy(batch)},
                                 tcfg)
        tc = TM.init_cache(tcfg, B, S, device="cpu", dtype=tdt)
        tsteps = []
        for t in range(DECODE):
            lg, tc = TM.decode_step(model, tc,
                                    torch.from_numpy(tokens[:, t:t + 1]),
                                    tcfg)
            tsteps.append(_np(lg))
    return dict(mode=mode, cfg=tcfg,
                ref=dict(logits=jl, last=jlast, pre=jpre, steps=jsteps,
                         cache=jc),
                port=dict(logits=tl, last=tlast, pre=tpre, steps=tsteps,
                          cache=tc))


def test_forward_matches_reference(runs):
    tol = MODEL_TOL[runs["mode"]]
    got, want = runs["port"]["logits"], runs["ref"]["logits"]
    assert got.dtype == torch.float32
    _close(_np(got), want, tol, "forward logits")


def test_prefill_matches_reference(runs):
    tol = MODEL_TOL[runs["mode"]]
    port, ref = runs["port"], runs["ref"]
    _close(_np(port["last"]), ref["last"], tol, "prefill logits")
    # the reference's caches: ssm/conv for "ssm", none for "hybrid"
    assert sorted(port["pre"]) == sorted(ref["pre"])
    for key in port["pre"]:
        _close(_np(port["pre"][key]), np.asarray(ref["pre"][key], np.float32),
               tol, f"prefill {key} cache")
        assert port["pre"][key].dtype == {"ssm": torch.float32}.get(
            key, _act(runs["mode"])[1])


def test_decode_steps_match_reference(runs):
    tol = MODEL_TOL[runs["mode"]]
    port, ref = runs["port"], runs["ref"]
    for t, (got, want) in enumerate(zip(port["steps"], ref["steps"])):
        _close(got, want, tol, f"decode step {t}")
    assert port["cache"]["cur"] == int(ref["cache"]["cur"]) == DECODE
    for key in ("ssm", "conv", "k", "v", "pos"):
        if key in ref["cache"]:
            _close(_np(port["cache"][key]),
                   np.asarray(ref["cache"][key], np.float32),
                   tol if key != "pos" else 0.0, f"decode {key} cache")


def _ssd_inputs(seed, b=2, l=32, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a, bm, cm, d


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_reference(mode, chunk):
    """The chunked SSD scan with its final-state handoff, over one chunk
    and over four (the inter-chunk recurrence)."""
    x, dt, a, bm, cm, d = _ssd_inputs(chunk)
    jdt, tdt = _act(mode)
    with _reference_mode(mode):
        jy, js = JM2.ssd_chunked(
            jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(a),
            jnp.asarray(bm).astype(jdt), jnp.asarray(cm).astype(jdt),
            jnp.asarray(d), chunk, return_state=True)
    with _port_mode(mode):
        ty, ts = TM2.ssd_chunked(
            torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
            torch.from_numpy(a), torch.from_numpy(bm).to(tdt),
            torch.from_numpy(cm).to(tdt), torch.from_numpy(d), chunk,
            return_state=True)
    assert ty.dtype == tdt and ts.dtype == torch.float32
    _close(_np(ty), np.asarray(jy, np.float32), TOL[mode], "ssd y")
    _close(_np(ts), np.asarray(js), TOL[mode], "ssd final state")


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_apply_mamba2_matches_reference(models, mode, phase):
    """One mamba2 block: the chunked prefill with its handoff state, and a
    single-token decode from a nonzero state."""
    jcfg, tcfg, params, model, _ = models
    jdt, tdt = _act(mode)
    lp = jax.tree.map(lambda a: a[0], params["layers"])["mamba"]
    rng = np.random.default_rng(5)
    length = S if phase == "prefill" else 1
    x = rng.standard_normal((B, length, jcfg.d_model)).astype(np.float32)
    state = None
    if phase == "decode":
        st = JM2.init_decode_state(jcfg, B)
        tst = TM2.init_decode_state(tcfg, B, device="cpu")
        assert {k: tuple(v.shape) for k, v in tst.items()} == {
            k: v.shape for k, v in st.items()}
        state = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
                 for k, v in st.items()}
    with _reference_mode(mode):
        jo, jst = JM2.apply_mamba2(
            lp, jnp.asarray(x).astype(jdt), jcfg,
            state=None if state is None else {
                "ssm": jnp.asarray(state["ssm"]),
                "conv": jnp.asarray(state["conv"]).astype(jdt)})
    with _port_mode(mode):
        to, tst = TM2.apply_mamba2(
            model.layers[0].mamba, torch.from_numpy(x).to(tdt), tcfg,
            state=None if state is None else {
                "ssm": torch.from_numpy(state["ssm"]),
                "conv": torch.from_numpy(state["conv"]).to(tdt)})
    _close(_np(to), np.asarray(jo, np.float32), TOL[mode], "block output")
    for key in ("ssm", "conv"):
        _close(_np(tst[key]), np.asarray(jst[key], np.float32), TOL[mode],
               f"new {key} state")


def test_prefill_state_matches_stepwise_decode():
    """The handoff the serving loop relies on: one chunked prefill leaves
    the same ssm/conv state as decoding the prompt token by token, within
    the reference's own bound for it (tests/test_prefill_handoff.py,
    rtol = atol = 2e-2).  The chunked and the recurrent forms round
    differently; in f32 the reference itself ends 5.9e-4 apart on a
    max|state| of 0.15 here, and so does the port."""
    cfg = treduced(tget("mamba2-130m"))
    jcfg = jreduced(jget("mamba2-130m"))
    params = JM.init_params(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                      device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 2 * cfg.ssm_chunk), dtype=np.int32))
    with _port_mode("f32"):
        cache = TM.init_cache(cfg, 1, toks.shape[1], device="cpu",
                              dtype=torch.float32)
        for t in range(toks.shape[1]):
            _, cache = TM.decode_step(model, cache, toks[:, t:t + 1], cfg)
        _, pre = TM.prefill(model, {"tokens": toks}, cfg)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(_np(pre[key]), _np(cache[key]),
                                   rtol=2e-2, atol=2e-2)


def test_conv_taps_stay_fp32_at_rest(models):
    """bf16 at rest stores the projections in bf16 but keeps the conv taps
    and the 1-D parameters fp32 (F32GER reads the taps as fp32), in both
    ``convert`` and ``init_params``; and bf16 at rest gives the per-call
    cast's logits exactly."""
    jcfg, tcfg, params, model, tokens = models
    rest = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     device="cpu", dtype=torch.bfloat16)
    fresh = TM.init_params(tcfg, device="cpu", dtype=torch.bfloat16)
    for m in (rest, fresh):
        mb = m.layers[0].mamba
        assert mb.in_proj.dtype == mb.out_proj.dtype == torch.bfloat16
        assert mb.conv_w.dtype == mb.conv_b.dtype == torch.float32
        assert mb.A_log.dtype == mb.D.dtype == torch.float32
        assert (m.shared_attn is None) == (tcfg.family == "ssm")
        if m.shared_attn is not None:
            assert m.shared_attn.in_proj.dtype == torch.bfloat16
            assert m.shared_attn.in_proj.shape == (2 * tcfg.d_model,
                                                   tcfg.d_model)
    batch = {"tokens": torch.from_numpy(tokens)}
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        a, _, _ = TM.forward(model, batch, tcfg)
        b, _, _ = TM.forward(rest, batch, tcfg)
    assert torch.equal(a, b)


def test_scatter_prefill_matches_reference():
    """Exact per-slot handoff for the ssm kind; dense and hybrid caches
    are left as they are, as in the reference."""
    rng = np.random.default_rng(7)
    for name in ARCHS:
        tcfg = treduced(tget(name))
        cache = TM.init_cache(tcfg, 3, 8, device="cpu")
        pre = {"ssm": rng.standard_normal(
                   (tcfg.num_layers, 1) + cache["ssm"].shape[2:]).astype(
                       np.float32),
               "conv": rng.standard_normal(
                   (tcfg.num_layers, 1) + cache["conv"].shape[2:]).astype(
                       np.float32)}
        jcache = {k: (jnp.asarray(_np(v)).astype(
                          jnp.bfloat16 if v.dtype == torch.bfloat16
                          else jnp.float32) if torch.is_tensor(v) else v)
                  for k, v in cache.items()}
        want = jserve._scatter_prefill(
            jcache, {k: jnp.asarray(v) for k, v in pre.items()}, 1, None)
        got = tserve._scatter_prefill(
            cache, {k: torch.from_numpy(v) for k, v in pre.items()}, 1)
        for key in ("ssm", "conv"):
            np.testing.assert_array_equal(_np(got[key]),
                                          np.asarray(want[key], np.float32))
        if name == "zamba2-1.2b":
            assert not got["ssm"].any()


COMPARED = ("completed", "rejected", "steps", "decode_tokens",
            "prefill_tokens", "latency_p50_steps", "latency_p99_steps",
            "pages")


@pytest.mark.parametrize("name", ARCHS)
def test_serve_loop_matches_reference(name):
    """The serving loop on reduced mamba2-130m (the exact per-slot
    handoff) and zamba2 (hybrid: the handoff is skipped), against the
    reference's under ``use_pallas=True`` (see the module note)."""
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    params = JM.init_params(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu", dtype=torch.bfloat16)
    kw = dict(batch=2, prompt_len=16, gen_len=4, n_requests=3, seed=0)
    with jfac.configure(jfac.FacilityConfig(use_pallas=True)):
        want = jserve.serve_loop(jcfg, params, **kw)
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        got = tserve.serve_loop(tcfg, model, **kw)
    for key in COMPARED:
        assert got[key] == want[key], key
    assert got["completed"] == 3
