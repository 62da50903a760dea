"""The port's dense model (repro_torch.models) against the JAX reference on
reduced deepseek-7b and glm4-9b (GQA group 4), on the CPU.

Weights come from the reference's ``init_params`` through
``models.convert.params_from_numpy``; tokens from numpy with a fixed seed.
Checked here: ``forward`` logits and ``prefill`` (last logits and the k/v
cache), and a sliding window that binds (h2o-danube-3-4b); the
``decode_step`` checks on the same fixture are in
tests/test_torch_decode.py.

Tolerances:
  * ``FacilityConfig(ger=F32GER, out_dtype=float32)``: within 1e-4 of
    max|ref| (only the first layer's bf16 embedding is rounded; the rest
    is fp32 summed in another order);
  * the BF16GER2/bf16 default: within 2^-8 (one bf16 ulp) of max|ref|.
    Every contract rounds its output to bf16; a sum that lands within an
    fp32 rounding error of a bf16 tie may round the other way and travel
    on, which one ulp of the largest logit covers at these sizes.  (On
    this CPU the bf16 k/v caches agree bit for bit and the logits to
    ~3e-7 of max|ref|.)
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
from repro.models import model as JM
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get as tget
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.models import convert
from repro_torch.models import model as TM

CONFIGS = {
    "f32": (dict(ger=jprec.Ger.F32GER, out_dtype=jnp.float32),
            dict(ger=tprec.Ger.F32GER, out_dtype=torch.float32),
            jnp.float32, torch.float32, 1e-4),
    "bf16": ({}, {}, jnp.bfloat16, torch.bfloat16, 2.0 ** -8),
}

B, S, DECODE = 2, 12, 4


def _reference_mode(mode):
    """The reference's facility config for ``mode``.  In f32 mode the bf16
    embedding turns into f32 activations after layer 0, which a lax.scan
    carry cannot hold, so the reference runs its python-loop layer mode
    (``eager_layers``) there."""
    stack = contextlib.ExitStack()
    stack.enter_context(jfac.configure(jfac.FacilityConfig(
        **CONFIGS[mode][0])))
    if mode == "f32":
        stack.enter_context(JM.eager_layers())
    return stack


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max|err| {err} > {tol} * {scale}"


@pytest.fixture(scope="module", params=["deepseek-7b", "glm4-9b"])
def models(request):
    name = request.param
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    params = JM.init_params(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    model = convert.params_from_numpy(tree, tcfg, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S + DECODE), dtype=np.int32)
    return jcfg, tcfg, params, model, tokens


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_forward_and_prefill_match_reference(models, mode):
    jcfg, tcfg, params, model, tokens = models
    _, tkw, _, _, tol = CONFIGS[mode]
    batch_np = tokens[:, :S]
    with _reference_mode(mode):
        jlogits, _, _ = JM.forward(params, {"tokens": jnp.asarray(batch_np)},
                                   jcfg)
        jlast, jcache = JM.prefill(params, {"tokens": jnp.asarray(batch_np)},
                                   jcfg)
    with tfac.configure(tfac.FacilityConfig(device="cpu", **tkw)):
        tlogits, _, _ = TM.forward(model, {"tokens": torch.from_numpy(
            batch_np)}, tcfg)
        tlast, tcache = TM.prefill(model, {"tokens": torch.from_numpy(
            batch_np)}, tcfg)
    assert tlogits.dtype == torch.float32
    _close(tlogits.numpy(), jlogits, tol, "forward logits")
    _close(tlast.numpy(), jlast, tol, "prefill logits")
    for i, what in enumerate(("k", "v")):
        _close(tcache["kv"][i].float().numpy(),
               np.asarray(jcache["kv"][i], np.float32), tol,
               f"prefill {what} cache")


def test_bf16_at_rest_matches_per_call_cast(models):
    """Storing the 2-D weights in bf16 once gives the reference's per-call
    bf16 cast exactly: same logits, bit for bit, as fp32 storage."""
    jcfg, tcfg, params, model, tokens = models
    tree = jax.tree.map(np.asarray, params)
    rest = convert.params_from_numpy(tree, tcfg, device="cpu",
                                     dtype=torch.bfloat16)
    assert rest.layers[0].attn.wq.dtype == torch.bfloat16
    assert rest.final_norm.scale.dtype == torch.float32
    batch = {"tokens": torch.from_numpy(tokens[:, :S])}
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        a, _, _ = TM.forward(model, batch, tcfg)
        b, _, _ = TM.forward(rest, batch, tcfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", TARCHS)
def test_every_registry_arch_builds_at_its_reduced_size(name):
    """Every family of the port's registry is ported: ``check_family``
    accepts it and ``init_params`` builds its reduced model with the
    reference's parameter count."""
    cfg = treduced(tget(name))
    assert TM.check_family(cfg) in ("dense", "moe", "ssm", "hybrid",
                                    "cross")
    model = TM.init_params(cfg, device="cpu")
    want = jax.eval_shape(lambda k: JM.init_params(jreduced(jget(name)), k),
                          jax.random.key(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(want))


def test_sliding_window_matches_reference():
    """h2o-danube-3-4b reduced with a 4-slot window: the window binds in
    prefill (flash path) and the 4-slot ring wraps during decode."""
    import dataclasses

    jcfg = dataclasses.replace(jreduced(jget("h2o-danube-3-4b")),
                               sliding_window=4)
    tcfg = dataclasses.replace(treduced(tget("h2o-danube-3-4b")),
                               sliding_window=4)
    params = JM.init_params(jcfg, jax.random.key(1))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S),
                                               dtype=np.int32)
    tol = CONFIGS["bf16"][-1]
    jlogits, _, _ = JM.forward(params, {"tokens": jnp.asarray(tokens)}, jcfg)
    jcache = JM.init_cache(jcfg, B, S)
    jsteps = []
    for t in range(6):
        lg, jcache = JM.decode_step(params, jcache,
                                    jnp.asarray(tokens[:, t:t + 1]), jcfg)
        jsteps.append(np.asarray(lg, np.float32))
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        tlogits, _, _ = TM.forward(model, {"tokens": torch.from_numpy(
            tokens)}, tcfg)
        _close(tlogits.numpy(), jlogits, tol, "windowed forward logits")
        tcache = TM.init_cache(tcfg, B, S, device="cpu")
        assert tcache["pos"].shape == (4,)
        for t in range(6):
            lg, tcache = TM.decode_step(
                model, tcache, torch.from_numpy(tokens[:, t:t + 1]), tcfg)
            _close(lg.numpy(), jsteps[t], tol, f"windowed decode step {t}")
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    _close(tcache["k"].float().numpy(), np.asarray(jcache["k"], np.float32),
           tol, "windowed k cache")
